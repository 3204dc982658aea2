"""`describe` command (JAX ``cli/describe.py``): inspect training
checkpoints and torch exports WITHOUT loading weights onto a device.

- checkpoint directories: the port's Trainer output (and JAX Orbax
  directories where ``orbax`` imports), a per-step metrics table
  (epoch, val_f1, optimal_threshold, ema_decay, preempted),
- reference-format ``.pth`` exports (epoch / metrics / tensor census),
  read with ``torch.load(weights_only=True)`` and numpy's reconstructors
  allowed (``models/convert.py::load_torch_checkpoint``).

Serving-artifact directories wait for their module (ROADMAP Queue 1
item 8); ``describe`` names that item for one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

_ARTIFACT_TODO = ("serving artifacts (models/artifact.py) are not ported: "
                  "ROADMAP Queue 1 item 8")


def _describe_checkpoint_dir(path: Path) -> dict:
    from ..utils.checkpoint import _is_orbax_dir, _port_steps, list_checkpoints
    steps = list_checkpoints(str(path))
    orbax = not _port_steps(str(path)) and _is_orbax_dir(str(path))
    return {
        "kind": "orbax_checkpoint" if orbax else "checkpoint_dir",
        "path": str(path),
        "steps": [{"step": s, **m} for s, m in steps],
        "latest_step": steps[-1][0] if steps else None,
    }


def _describe_torch_file(path: Path) -> dict:
    import torch

    from ..models.convert import _numpy_safe_globals
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        obj = torch.load(str(path), map_location="cpu", weights_only=True)
    out = {"kind": "torch_checkpoint", "path": str(path)}
    sd = obj.get("model_state_dict", obj) if isinstance(obj, dict) else obj
    if isinstance(obj, dict) and "model_state_dict" in obj:
        # reference save_checkpoint format (train_advanced.py:475-489)
        out["epoch"] = obj.get("epoch")
        out["metrics"] = obj.get("metrics")
        out["config"] = obj.get("config")
    if hasattr(sd, "items"):
        out["tensors"] = len(sd)
        out["tensor_bytes"] = int(sum(
            t.numel() * t.element_size() for t in sd.values()
            if hasattr(t, "numel")))
    return out


def describe_path(target: str, verify: bool = False) -> dict:
    """``verify`` re-hashes a serving artifact's bytes in the JAX verb;
    the port has no artifacts yet (see the module docstring)."""
    p = Path(target)
    if p.is_dir():
        if (p / "meta.json").exists():
            meta = json.loads((p / "meta.json").read_text())
            if "format_version" in meta:
                raise NotImplementedError(_ARTIFACT_TODO)
        return _describe_checkpoint_dir(p)
    if p.is_file():
        return _describe_torch_file(p)
    raise FileNotFoundError(f"no such checkpoint/artifact: {target}")


def _fmt_bytes(n):
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024


def _print_human(info: dict):
    kind = info["kind"]
    if kind in ("orbax_checkpoint", "checkpoint_dir"):
        print(f"{kind.replace('_', ' ')}  {info['path']}  "
              f"(latest step {info['latest_step']})")
        for row in info["steps"]:
            extras = "  ".join(
                f"{k}={row[k]:.4g}" if isinstance(row[k], float)
                else f"{k}={row[k]}"
                for k in ("epoch", "val_f1", "optimal_threshold",
                          "ema_decay", "preempted") if k in row)
            print(f"  step {row['step']:>8}  {extras}")
    else:
        print(f"torch checkpoint  {info['path']}")
        if "epoch" in info:
            print(f"  epoch={info['epoch']}  metrics={info.get('metrics')}")
        if "tensors" in info:
            print(f"  {info['tensors']} tensors / "
                  f"{_fmt_bytes(info['tensor_bytes'])}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Inspect checkpoints / torch exports (no device, no "
                    "weights loaded onto it)")
    parser.add_argument("targets", nargs="+",
                        help="checkpoint directories and/or .pth files")
    parser.add_argument("--verify", action="store_true",
                        help="re-hash serving-artifact bytes against the "
                        "descriptor checksums (artifacts: ROADMAP Queue 1 "
                        "item 8)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output (one JSON object "
                        "per line)")
    args = parser.parse_args(argv)

    results = []
    for target in args.targets:
        if not os.path.exists(target):
            parser.error(f"no such checkpoint/artifact: {target}")
        try:
            info = describe_path(target, verify=args.verify)
        except NotImplementedError as e:
            print(f"{target}: {e}", file=sys.stderr)
            sys.exit(2)
        results.append(info)
        if args.json:
            print(json.dumps(info, default=str))
        else:
            _print_human(info)
    return results


if __name__ == "__main__":
    main()
