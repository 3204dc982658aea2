"""A copy of the benchmark at a tiny size, for runs on the CPU: the same
files under a temporary root, every configuration cut to a width and
depth the CPU runs in seconds, every traffic mix to a few small
batches."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

TINY = {"image_size": 32, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 256,
        "head_hidden_size": 16}
TINY_TRAFFIC = {"bulk_b128": {"batch": 8, "pool_batches": 3},
                "bulk_b32": {"batch": 4, "pool_batches": 3},
                "train_b128": {"batch": 8, "pool_batches": 4}}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and a tiny copy of ``padbench``
    (its tests left out)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "padbench", tmp / "padbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in (tmp / "padbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update({k: v for k, v in TINY.items()
                    if k != "head_hidden_size" or cfg["head"] == "mlp"})
        path.write_text(json.dumps(cfg))
    for name, over in TINY_TRAFFIC.items():
        path = tmp / "padbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **over}))
    return tmp


def run(root: Path, cell: str, *, seed: int = 12345, seconds: float = 0.5,
        trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU, the chip's look skipped."""
    import time
    from padbench.harness import Manifest, run_cell
    return run_cell(Manifest(root), cell, seed=seed, seconds=seconds,
                    trace=trace, device=torch.device("cpu"),
                    t_start=time.perf_counter())
