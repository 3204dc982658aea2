"""Where the time of a whole-encoder launch goes, phase by phase and inside
a unit, from the kernels' own timer stamps (ops/lowlat.py ``trace``).

    python tests/lowlat_stamps.py [TREE]

For kernel 10 at B 1 (encoder-only, 12 ViT-B/16 layers on random packs)
and kernel 11 per chunk of 2, the median over the layers of each phase's
time (from block 0's barrier stamps: the phase and its barrier), and of
the stamps every block writes for its first unit of a phase, relative to
the phase's start (block 0 leaving the barrier before it), in µs:
``start`` (the unit starts), ``w_ready`` (its first A and weight tiles
are in shared memory), ``kloop`` (its products are done), ``stored`` (its
epilogue or partial sums are written), ``end`` (the block's work in the
phase is done), each as the median and the maximum over the blocks (in
the attention phase the middle three are: K and V landed, the row stats
combined, P V done), and ``w_issued`` (the producer issued the phase's
first weight load: < 0 is before the barrier).  Then ``tail``: the phase's end at block 0 less
the last block's ``end`` (the barrier).  Needs a CUDA card.

TREE (default ``.``) is a checkout whose ``ops/lowlat.py`` has
``unit_trace_slots``.  A parent without unit stamps is measured with the
instrumentation in ``tests/lowlat_parent_stamps.patch`` applied to its
``csrc/`` (``patch -p1 -d TREE < tests/lowlat_parent_stamps.patch``):
its stamps start at trace[4096], five a block (no ``w_issued``), over
its grid of two blocks an SM, with the split-K fixup in ``end``.
Prints one JSON object, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

D, TP, T, HEADS, DEPTH = 768, 200, 197, 12, 12
NAMES = ("start", "w_ready", "kloop", "stored", "end")


def main(argv) -> int:
    tree = argv[0] if argv else "."
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from vit_spoof_detection_pda_tpu_torch.ops import lowlat as low

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def scaled(*shape, scale, dt=torch.bfloat16):
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                * scale).to(dev, dt)

    s_pack = scaled(3 * DEPTH, 4, 4 * D, scale=0.05, dt=torch.float32)
    s_pack[:, 0] += 1.0
    w_pack = scaled(3 * DEPTH, D, 4 * D, scale=D ** -0.5)
    new = hasattr(low, "unit_trace_slots")
    out = {}
    for key, fn, b, kernel in (
            ("kernel10_b1", low.encoder_forward_lowlat, 1, "lowlat_encoder"),
            ("kernel11_chunk2", low.encoder_forward_lowlat_batchgrid, 2,
             "lowlat_batchgrid")):
        xp = scaled(b, TP, D, scale=1.0)
        if new:
            plan = low.lowlat_plan(b, TP, D, HEADS, sms, kernel, depth=DEPTH)
            phases = [p["name"] for p in plan["phases"]]
            base, grid, per = plan["trace_slots"], plan["grid"], 6
            n = low.unit_trace_slots(plan)
        else:      # the instrumented parent: 7 phases a layer (8 in kernel 11)
            layer = ["ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2"]
            if kernel == "lowlat_batchgrid":
                layer = layer[:-1] + ["fc2_a", "fc2_b"]
            phases = layer * DEPTH
            base, grid, per = 4096, 2 * sms, 5
            n = base + (5 + len(phases)) * grid * per
        trace = torch.zeros(n, dtype=torch.int64, device=dev)
        for _ in range(4):           # the last of four traced launches
            trace.zero_()
            fn(xp, w_pack, s_pack, num_heads=HEADS, valid_len=T, trace=trace)
            torch.cuda.synchronize()
        tr = trace.cpu().numpy().astype(np.float64)
        bars = tr[:5 + len(phases)]
        units = tr[base:base + (5 + len(phases)) * grid * per].reshape(
            -1, grid, per)
        stats = {}
        for i, name in enumerate(phases):
            t0, t1 = bars[4 + i], bars[5 + i]
            # the unit stamps' phase index: the new core counts phases, the
            # parent the barriers crossed (4 empty ones first)
            u = units[i if new else 4 + i]
            live = u[:, 0] > 0
            rec = {"phase": (t1 - t0) / 1e3}
            if live.any():
                u = u[live]
                for j, nm in enumerate(NAMES):
                    ok = u[:, j] > 0
                    if ok.any():
                        d = (u[ok, j] - t0) / 1e3
                        rec[nm] = [float(np.median(d)), float(d.max())]
                if per > 5 and (u[:, 5] > 0).any():
                    rec["w_issued"] = float(
                        np.median(u[u[:, 5] > 0, 5] - t0) / 1e3)
                rec["tail"] = (t1 - u[:, 4].max()) / 1e3
                rec["blocks"] = int(live.sum())
            stats.setdefault(name, []).append(rec)
        agg = {}
        for name, recs in stats.items():
            keys = [k for k in recs[0] if all(k in r for r in recs)]
            agg[name] = {k: np.round(np.median(np.array(
                [r[k] for r in recs], dtype=np.float64), axis=0), 2).tolist()
                for k in keys}
        agg["bare_barrier"] = float(np.median(np.diff(bars[:5])) / 1e3)
        agg["traced_ms"] = float((bars[4 + len(phases)] - bars[4]) / 1e6)
        out[key] = agg
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
