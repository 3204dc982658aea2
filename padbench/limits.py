"""The readings that each cell's limits are set from (PERF.md gives them):
the lower from sound runs of the program over many seeds, the upper from
the control (the reference in the program's place, one precision below
the configuration's) and, for training, from a fault planted in the
reference put in the program's place.  Training's uncompared readings
(each step's loss, the first gradient's norm) are worked out here only.

    python3 padbench/limits.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3] [--faults] [--seconds 2]

prints one JSON line per reading.  The benchmark's own runs never run
this; ``tests/test_control.py`` holds the control against the limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from padbench import check, generate, weights  # noqa: E402
from padbench.harness import Manifest, run_cell  # noqa: E402
from padbench.reference import vit as ref  # noqa: E402


def control_scores(manifest, cell: str, seed: int, device) -> dict:
    """The control's score gaps over every distinct input of a scoring
    cell: P(live) of the reference at the control's precision, in blocks
    of the cell's batch, against the reference's."""
    cfg = manifest.config(manifest.cells[cell]["config"])
    traffic = manifest.traffic(manifest.cells[cell]["traffic"])
    quant = ref.CONTROLS[manifest.workload(cell)["control"]]
    pool = generate.pool(seed, traffic, cfg["image_size"], device)
    images = torch.from_numpy(pool["images"]).to(device)
    w = weights.make(cfg, seed, device)
    want = ref.p_live(w, images, cfg).cpu().numpy()
    got = ref.p_live(w, images, cfg, quant, block=pool["batch"]).cpu().numpy()
    out = check.score_gaps(got, want, np.arange(len(want)))
    if cfg["head"] == "mlp":
        # what the serving paths' tanh GELU alone reads, at float32
        tanh = ref.p_live(w, images, cfg, act=ref.gelu_tanh).cpu().numpy()
        out["tanh_only"] = check.score_gaps(tanh, want,
                                            np.arange(len(want)))
    return out


def loss_gaps(losses, want) -> dict:
    """Readings that no limit compares: ``loss_gap``, the largest relative
    gap of a step's loss, and ``loss1_gap``, the first step's."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(losses, want)]
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0]}


def control_training(manifest, cell: str, seed: int, device,
                     faults: bool) -> dict:
    """The training numbers of the reference at the control's precision
    (and of the planted fault, half of each batch left out) against the
    reference's, on the cell's first three batches.  The third fault, a
    state left unchanged, reads 1 on ``change_gap`` and needs no run."""
    cfg = manifest.config(manifest.cells[cell]["config"])
    traffic = manifest.traffic(manifest.cells[cell]["traffic"])
    pool = generate.pool(seed, traffic, cfg["image_size"], device)
    b = pool["batch"]
    feed = [(torch.from_numpy(pool["images"][i * b:(i + 1) * b]).to(device),
             torch.from_numpy(pool["labels"][i * b:(i + 1) * b]).to(device))
            for i in range(3)]
    seeds = [generate.sub_seed(seed, 5, s) for s in range(3)]
    w0 = weights.make(cfg, seed, device)
    want = ref.train_steps(w0, feed, seeds, cfg, cfg["optimizer"])
    variants = {"control": (feed, dict(quant=ref.CONTROLS[
        manifest.workload(cell)["control"]]))}
    if faults:
        # half of each batch left out, the mean taken over the rest
        half = [(x[:b // 2], y[:b // 2]) for x, y in feed]
        variants["half_batch"] = (half, {})
    out = {}
    for name, (batches, kw) in variants.items():
        got = ref.train_steps(w0, batches, seeds, cfg, cfg["optimizer"],
                              **kw)
        got_d3 = {k: got["params"][k] - w0[k] for k in w0}
        out[name] = dict(check.training_gaps(got["grad1"], got_d3, want,
                                             w0),
                         grad_gap=check.worst_leaf_gap(got["grad1"],
                                                       want["grad1"])[0],
                         **loss_gaps(got["loss"], want["loss"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    manifest = Manifest(ROOT)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t = time.perf_counter()
        r = run_cell(manifest, args.workload, seed=seed,
                     seconds=args.seconds, trace=False, device=dev,
                     t_start=time.perf_counter())
        readings = r["_readings"]
        if "losses" in readings:
            readings.update(loss_gaps(readings["losses"],
                                      readings["ref_losses"]))
        print(json.dumps({"reading": "program", "seed": seed,
                          "correct": r["correct"], "metrics": r["metrics"],
                          "checks": {k: v["value"] for k, v in
                                     r["checks"].items()},
                          "readings": readings,
                          "s": time.perf_counter() - t}), flush=True)
    driver = manifest.workload(args.workload)["driver"]
    for seed in args.control_seeds:
        if driver == "train":
            got = control_training(manifest, args.workload, seed, dev,
                                   args.faults)
            for name, nums in got.items():
                print(json.dumps({"reading": name, "seed": seed,
                                  "checks": nums}), flush=True)
        else:
            print(json.dumps({"reading": "control", "seed": seed,
                              "checks": control_scores(
                                  manifest, args.workload, seed, dev)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
