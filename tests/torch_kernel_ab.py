"""The bf16 attention backwards of several checkouts, timed in turns on
one card: kernel 4 (``csrc/attention_qkv_bwd.cu``) and, where the
checkout has it, kernel 13 (``csrc/attention_cp_bwd.cu``).

    python tests/torch_kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (a ``git archive`` unpacked into a
directory that ``.gitignore`` lists, or ``.`` for this one); name them in
the order to run, e.g. ``parent . . parent``.  For each, one process
imports that tree's port, builds both kernels from its sources (into
that tree's ``build/``), prints ptxas's register and spill report for each
head-dim-64 instantiation, and times ``ops.attention.attention_qkv_bwd``
at the fasttrain step's shape (ViT-B/16: B 128, Tp 200, D 768, 12 heads,
197 valid rows) and ``ops.attention.attention_cp_bwd`` at the 2-rank
sequence-parallel step's (B 128, Tq 104, Tk 208, 197 valid keys), on
numpy-seeded operands, the same in every tree, each as the median of 5
windows of 20 calls between CUDA events.  Prints one JSON line per tree,
then the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

B, TP, T, D, HEADS = 128, 200, 197, 768, 12
TQ, TK = 104, 208                  # one of two sequence ranks' blocks


def _child(tree: str) -> None:
    import statistics

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from vit_spoof_detection_pda_tpu_torch.ops import _build
    from vit_spoof_detection_pda_tpu_torch.ops import attention as att

    names = [n for n in ("attention_qkv_bwd", "attention_cp_bwd")
             if n in _build.KERNELS]
    _build.build(names)
    ptxas = {}
    for name in names:
        lines = _build.build_log(name).splitlines()
        ptxas[name] = [
            ln.split(":", 1)[-1].strip() for i, ln in enumerate(lines)
            if ("registers" in ln or "spill" in ln)
            and any("ILi64E" in prev and "bwd" in prev
                    for prev in lines[max(0, i - 2):i])]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, torch.bfloat16)

    qkv, g = bf(B, TP, 3 * D), bf(B, TP, D)
    g[:, T:] = 0
    runs = {"attention_qkv_bwd": lambda: att.attention_qkv_bwd(
        qkv, g, HEADS, valid_len=T)}
    if "attention_cp_bwd" in names:
        q, kv, gq = bf(B, TQ, D), bf(B, TK, 2 * D), bf(B, TQ, D)
        runs["attention_cp_bwd"] = lambda: att.attention_cp_bwd(
            q, kv, gq, HEADS, T)
    ms, sums = {}, {}
    for name, run in runs.items():
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        windows = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            end.synchronize()
            windows.append(start.elapsed_time(end) / 20)
        ms[name] = statistics.median(windows)
        out = run()
        out = out if isinstance(out, tuple) else (out,)
        sums[name] = [float(o.float().abs().sum()) for o in out]
    print(json.dumps({"tree": tree, "ms": ms, "ptxas": ptxas,
                      "out_abs_sums": sums}))


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        _child(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--child", tree],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
