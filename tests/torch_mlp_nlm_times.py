"""Kernels 2 and 16 of one checkout on the card, for timing variants of
them: ptxas's report, agreement with the plain versions, the exhaustive
division check of kernel 16, and times.

    python tests/torch_mlp_nlm_times.py TREE [NAME,...]

TREE is the root of a checkout (``.`` for this one, or a copy under
``.archive/`` with one constant edited); run several in one command, the
parent among them, and compare only within it.  It builds that tree's
``nlm``, ``mlp_block`` and ``gemm`` libraries and prints one JSON line:

- ``errs``: kernel 16's largest difference from ``nlm_denoise_plain`` at
  the eval shape, ragged and tiny images, every channel count and both
  routes; kernel 2's at 1, 127, 129, 25,216 and 25,600 rows (ViT-B widths)
  beside 2 bf16 ulps of the output's largest magnitude;
- ``div_check``: for each norm (2p + 1)^2 C of p 0-2, C 1-4, how many of
  the 2^32 f32 inputs the register route's division gives otherwise than
  ``__fdiv_rn``, and the first (where the tree has ``nlm_div_check``);
- ``times``: ms a call by CUDA events (``ev``, the median of 5 windows of
  at least 3 ms) and by torch.profiler (``dev``, every kernel of 10 calls;
  ``by``: each kernel's) for kernel 16 at B 64, 224 x 224 x 3, kernel 2 at
  B 128, Tp 200, and its products on the GEMM core alone: fc1 with its
  GELU and with the bias only, fc2 with its residual and with the bias
  only, and a 768-wide product with the residual (proj's shape);
- ``ptxas``: the build logs' register, spill and C75xx lines.

NAME,... keeps only the named ``times`` runs.  Needs a CUDA card; imports
nothing of JAX.
"""

import json
import math
import os
import statistics
import sys


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    tree, only = argv[0], (argv[1].split(",") if len(argv) > 1 else None)
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from vit_spoof_detection_pda_tpu_torch.ops import _build
    from vit_spoof_detection_pda_tpu_torch.ops import attention as att
    from vit_spoof_detection_pda_tpu_torch.ops import gemm as gm
    from vit_spoof_detection_pda_tpu_torch.ops import nlm

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    libs = ("nlm", "mlp_block", "gemm")
    _build.build(libs)
    ptxas = {n: [ln.strip()[:160] for ln in _build.build_log(n).splitlines()
                 if any(k in ln for k in ("registers", "spill", "C75",
                                          "Compiling entry"))]
             for n in libs}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = {"tree": tree}

    def tol(w):
        return 2 * 2.0 ** (math.floor(math.log2(w.float().abs().max().item()))
                           - 7)

    errs = {}
    for label, shape, r, p in (
            ("b8_224", (8, 224, 224, 3), 5, 1),
            ("ragged", (2, 250, 190, 3), 5, 1),
            ("tiny_6x9", (1, 6, 9, 3), 5, 1), ("c1_p2", (2, 20, 17, 1), 2, 2),
            ("c4_p3", (1, 64, 64, 4), 5, 3),
            ("c2_r0p0", (2, 224, 224, 2), 0, 0),
            ("c4_p1", (1, 100, 70, 4), 3, 1),
            ("c1_p1", (2, 97, 133, 1), 5, 1)):
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        kw = dict(search_radius=r, patch_radius=p)
        errs["nlm_" + label] = (nlm.nlm_denoise(x, **kw)
                                - nlm.nlm_denoise_plain(x, **kw)
                                ).abs().max().item()

    def mlp_in(rows, d=768, hid=3072):
        def t(*shape, sc=1.0, dt=torch.bfloat16):
            return torch.from_numpy((rng.standard_normal(shape) * sc).astype(
                np.float32)).to(dev, dt)
        f32 = torch.float32
        return dict(x=t(1, rows, d), ln_scale=1 + t(d, sc=0.1, dt=f32),
                    ln_bias=t(d, sc=0.1, dt=f32),
                    w_fc1=t(d, hid, sc=d ** -0.5),
                    b_fc1=t(hid, sc=0.1, dt=f32),
                    w_fc2=t(hid, d, sc=hid ** -0.5),
                    b_fc2=t(d, sc=0.1, dt=f32))

    for rows in (1, 127, 129, 25216, 25600):
        m = mlp_in(rows)
        g, w = att.fused_mlp_block(**m), att.fused_mlp_block_plain(**m)
        errs[f"mlp_{rows}"] = [(g.float() - w.float()).abs().max().item(),
                               tol(w)]
    torch.cuda.synchronize()
    res["errs"] = errs
    if hasattr(nlm, "nlm_div_check"):
        res["div_check"] = {c * (2 * p + 1) ** 2:
                            nlm.nlm_div_check(c * (2 * p + 1) ** 2)
                            for c in (1, 2, 3, 4) for p in (0, 1, 2)}

    def window(fn, n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    def ev_ms(fn):
        for _ in range(3):
            fn()
        n = max(10, int(3.0 / window(fn, 3)) + 1)
        return statistics.median(window(fn, n) for _ in range(5))

    def dev_ms(fn, n=10):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.key[:60]] = (by.get(e.key[:60], 0)
                                  + e.self_device_time_total / 1e3 / n)
        return sum(by.values()), by

    x64 = torch.from_numpy(rng.random((64, 224, 224, 3), dtype=np.float32)
                           ).to(dev)
    m = mlp_in(25600)
    x2 = m["x"].view(25600, 768)
    xn = torch.from_numpy(rng.standard_normal((25600, 768)).astype(
        np.float32)).to(dev, torch.bfloat16)
    hh = torch.from_numpy((rng.standard_normal((25600, 3072)) * 0.5).astype(
        np.float32)).to(dev, torch.bfloat16)
    w_proj = m["w_fc1"][:, :768].contiguous()
    runs = {"nlm": lambda: nlm.nlm_denoise(x64),
            "mlp_block": lambda: att.fused_mlp_block(**m),
            "fc1_gelu": lambda: gm.gemm(xn, m["w_fc1"], m["b_fc1"],
                                        epilogue="bias_gelu"),
            "fc1_bias": lambda: gm.gemm(xn, m["w_fc1"], m["b_fc1"]),
            "fc2_res": lambda: gm.gemm(hh, m["w_fc2"], m["b_fc2"],
                                       epilogue="bias_residual", residual=x2),
            "fc2_bias": lambda: gm.gemm(hh, m["w_fc2"], m["b_fc2"]),
            "proj_res": lambda: gm.gemm(xn, w_proj, m["b_fc2"],
                                        epilogue="bias_residual", residual=x2)}
    times = {}
    for name, fn in runs.items():
        if only and name not in only:
            continue
        d, by = dev_ms(fn)
        times[name] = {"ev": ev_ms(fn), "dev": d,
                       "by": {k: round(v, 5) for k, v in by.items()}}
    res["times"] = times
    res["ptxas"] = ptxas
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
