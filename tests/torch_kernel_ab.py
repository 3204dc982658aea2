"""The attention kernels of several checkouts, timed in turns on one card,
each beside the PyTorch call that computes the same function:

- kernel 4 (``attention_qkv_bwd``) and kernel 5 (``attention_qkv_bwd_phased``)
  at the fasttrain step's shape (ViT-B/16: B 128, Tp 200, D 768, 12 heads,
  197 valid rows; f32 at B 32), beside the backward of
  ``scaled_dot_product_attention`` with the same key mask;
- kernel 12 (``fused_attention_qkv_cp``) and kernel 13
  (``attention_cp_bwd``) at the 2-rank sequence-parallel step's block
  (B 128, Tq 104, Tk 208, 197 valid keys; their f32 forms at B 32),
  beside ``scaled_dot_product_attention`` on the 197 real keys (the masked
  keys add exactly 0) and its backward;
- kernel 8 (``fused_attention_qkv``) at f32 (B 32, T 197), beside SDPA
  f32;
- at ViT-B/16, 384 px (B 8, T 577, Tp 584), kernel 5's route past its one
  launch (``..._384``: the four-launch long route before the key-tiled
  backward replaced it, the key-tiled backward after), bf16 and f32, beside
  SDPA's masked backward; and, in a tree that has the key-tiled routes
  (``ops/attention.py::tiled_bwd_plan``), kernel 13's key-tiled instance
  and kernel 12's f32 key tiles at the 2-rank block (Tq 296, Tk 592),
  kernel 8 f32 at T 577, and at 512 px (T 1025) kernel 12's bf16 key
  tiles (Tq 520, Tk 1040) and kernel 8 bf16 on them, beside SDPA.

    python tests/torch_kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (a ``git archive`` unpacked into a
directory that ``.gitignore`` lists, or ``.`` for this one); name them in
the order to run, e.g. ``parent . . parent``.  For each, one process
imports that tree's port, builds the kernels from its sources (into that
tree's ``build/``), prints ptxas's register and spill report for each
head-dim-64 instantiation of those kernels, and times each kernel and its
library call in turns (kernel, library, library, kernel), each turn 5
windows of 20 calls between CUDA events, on numpy-seeded operands that
are the same in every tree.  Prints one JSON line per tree (the medians
over both turns, in ms, and the sums of each output's magnitudes), then
the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

B, B32, TP, T, D, HEADS = 128, 32, 200, 197, 768, 12
TQ, TK = 104, 208                  # one of two sequence ranks' blocks
B384, T384, TP384 = 8, 577, 584    # ViT-B/16 at 384 px
TQ384, TK384 = 296, 592            # ... one of two sequence ranks' blocks
T512, TP512 = 1025, 1040           # ViT-B/16 at 512 px
NAMES = ("attention_qkv_bwd", "attention_qkv_bwd_f32",
         "attention_qkv_bwd_phased", "attention_qkv_bwd_phased_long",
         "attention_bwd_tiled", "attention_cp", "attention_cp_bwd",
         "attention_qkv")


def _ptxas(log: str) -> list:
    """(kernel, registers, spill line) of each head-dim-64 entry point."""
    out, entry, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1) if "Li64E" in m.group(1) else None
        elif entry and "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif entry and "registers" in ln:
            name = re.sub(r"^_ZN3vsd\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "", entry)
            out.append([name[:48], ln.split("Used")[1].split(",")[0].strip(),
                        spill])
            entry = None
    return out


def _child(tree: str) -> None:
    import statistics

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from vit_spoof_detection_pda_tpu_torch.ops import _build
    from vit_spoof_detection_pda_tpu_torch.ops import attention as att

    names = [n for n in NAMES if n in _build.KERNELS]
    _build.build(names)
    ptxas = {n: _ptxas(_build.build_log(n)) for n in names}
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rand(*shape, dt=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt)

    def sdpa_bwd(qkv, g, tk, valid):
        """SDPA's backward on the heads of ``qkv`` (keys past ``valid``
        masked) for the cotangent ``g``."""
        b, tq, d3 = qkv.shape
        q, k, v = (t.contiguous().requires_grad_() for t in qkv.view(
            b, tq, 3, HEADS, d3 // 3 // HEADS).permute(2, 0, 3, 1, 4))
        mask = (torch.arange(tk, device=dev) < valid).view(1, 1, 1, tk)
        o = sdpa(q, k, v, attn_mask=mask)
        go = g.view(b, tq, HEADS, -1).transpose(1, 2)
        return lambda: torch.autograd.grad(o, (q, k, v), go,
                                           retain_graph=True)

    def cp_runs(name, b, tq, tk, valid, dt, bwd):
        """Kernel 12 (or 13 with ``bwd``) on a (tq, tk) block beside SDPA
        (its backward) on the ``valid`` real keys."""
        q, kv = rand(b, tq, D, dt=dt), rand(b, tk, 2 * D, dt=dt)
        qh = q.view(b, tq, HEADS, -1).transpose(1, 2).contiguous()
        kh, vh = (t.view(b, tk, HEADS, -1).transpose(1, 2)[:, :, :valid]
                  .contiguous() for t in kv.split(D, -1))
        if not bwd:
            runs[name] = (
                lambda: att.fused_attention_qkv_cp(q, kv, HEADS, valid),
                lambda: sdpa(qh, kh, vh))
            return
        gq = rand(b, tq, D, dt=dt)
        qg, kg, vg = (t.requires_grad_() for t in (qh, kh, vh))
        o = sdpa(qg, kg, vg)
        go = gq.view(b, tq, HEADS, -1).transpose(1, 2)
        runs[name] = (
            lambda: att.attention_cp_bwd(q, kv, gq, HEADS, valid),
            lambda: torch.autograd.grad(o, (qg, kg, vg), go,
                                        retain_graph=True))

    def qkv_runs(name, b, t, dt):
        qkv = rand(b, t, 3 * D, dt=dt)
        q, k, v = qkv.view(b, t, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
        runs[name] = (lambda: att.fused_attention_qkv(qkv, HEADS),
                      lambda: sdpa(q, k, v))

    runs = {}
    for dt, b, sfx in ((torch.bfloat16, B, ""), (torch.float32, B32, "_f32")):
        qkv, g = rand(b, TP, 3 * D, dt=dt), rand(b, TP, D, dt=dt)
        g[:, T:] = 0
        lib = sdpa_bwd(qkv, g, TP, T)
        runs["attention_qkv_bwd" + sfx] = (
            lambda qkv=qkv, g=g: att.attention_qkv_bwd(
                qkv, g, HEADS, valid_len=T), lib)
        runs["attention_qkv_bwd_phased" + sfx] = (
            lambda qkv=qkv, g=g: att.attention_qkv_bwd_phased(
                qkv, g, HEADS, valid_len=T), lib)
        q, kv = rand(b, TQ, D, dt=dt), rand(b, TK, 2 * D, dt=dt)
        qh = q.view(b, TQ, HEADS, -1).transpose(1, 2).contiguous()
        kh, vh = (t.view(b, TK, HEADS, -1).transpose(1, 2)[:, :, :T]
                  .contiguous() for t in kv.split(D, -1))
        runs["attention_cp" + sfx] = (
            lambda q=q, kv=kv: att.fused_attention_qkv_cp(q, kv, HEADS, T),
            lambda qh=qh, kh=kh, vh=vh: sdpa(qh, kh, vh))
        cp_runs("attention_cp_bwd" + sfx, b, TQ, TK, T, dt, True)
    qkv_runs("attention_qkv_f32", B32, T, torch.float32)
    tiled = hasattr(att, "tiled_bwd_plan")
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        qkv, g = (rand(B384, TP384, 3 * D, dt=dt),
                  rand(B384, TP384, D, dt=dt))
        g[:, T384:] = 0
        runs["attention_qkv_bwd_phased_384" + sfx] = (
            lambda qkv=qkv, g=g: att.attention_qkv_bwd_phased(
                qkv, g, HEADS, valid_len=T384),
            sdpa_bwd(qkv, g, TP384, T384))
        if tiled:
            cp_runs("attention_cp_bwd_384" + sfx, B384, TQ384, TK384, T384,
                    dt, True)
    if tiled:
        cp_runs("attention_cp_384_f32", B384, TQ384, TK384, T384,
                torch.float32, False)
        qkv_runs("attention_qkv_384_f32", B384, T384, torch.float32)
        # kernel 12's bf16 key tiles, and kernel 8 bf16 on them, at 512 px
        cp_runs("attention_cp_512", B384, TP512 // 2, TP512, T512,
                torch.bfloat16, False)
        qkv_runs("attention_qkv_512", B384, T512, torch.bfloat16)

    def windows(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 20)
        return out

    ms, lib_ms, sums = {}, {}, {}
    for name, (run, lib) in runs.items():
        wk, wl = [], []
        for fn, acc in ((run, wk), (lib, wl), (lib, wl), (run, wk)):
            acc += windows(fn)
        ms[name], lib_ms[name] = statistics.median(wk), statistics.median(wl)
        out = run()
        out = out if isinstance(out, tuple) else (out,)
        sums[name] = [float(o.float().abs().sum()) for o in out]
    print(json.dumps({"tree": tree, "ms": ms, "library_ms": lib_ms,
                      "ptxas": ptxas, "out_abs_sums": sums}))


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
