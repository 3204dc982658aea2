"""Where a tile's time goes in the bf16 GEMM core (products against the
epilogue), from its own unit stamps, and how many instructions its
epilogue runs an element.

    python tests/gemm_stamps.py TREE [TREE ...]

For each TREE (a checkout's root, ``.`` for this one), builds that tree's
``csrc/gemm.cu`` with ``-DVSD_GEMM_STAMPS`` (``csrc/gemm_core.cuh``: each
consumer warpgroup's thread 0 stamps ``%clock64`` at a tile's start, when
its products are done and when its epilogue is, and ``%globaltimer`` and
``%clock64`` where the warpgroup starts and ends, which turn cycles into
ns) into ``TREE/build/stamps/``, and runs the core at the training MLP's
fc1 with its stored hidden (25,216 x 3,072 x 768, erf and tanh), the
serving MLP's fc1 with its GELU and with the bias only (25,600 rows), and
fc2 with the residual (25,600 x 768 x 3,072).  Per case, over every tile
of the last of 3 launches: the median and 90th percentile of ``products``
(tile start to products done, the wait on the ring included) and
``epilogue`` (products done to the epilogue's last TMA store issued), in
µs; ``epilogue_share`` (the epilogues' sum over the warpgroups' whole
time); the launch's ms by CUDA events (one warm launch, median of 5 of
the stamped build, so a shade above the plain build).  From the stamped
library's SASS (``cuobjdump``): ``epilogue_sass``, the instructions
between the second and third clock reads of each instantiation (the
epilogue, unrolled, stamps aside), over the 128 elements a consumer thread
holds a tile: instructions an element, and the most frequent opcodes.

A parent tree without the stamps takes them from
``tests/gemm_parent_stamps.patch`` (``patch -p1 -d TREE <
tests/gemm_parent_stamps.patch``).  Prints one JSON line per tree, then
the card's name and power limit.  Needs a CUDA card and ``nvcc``; imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

CASES = (("fc1_train_erf", 25216, 3072, 768, 3),
         ("fc1_train_tanh", 25216, 3072, 768, 4),
         ("fc1_gelu", 25600, 3072, 768, 1),
         ("fc1_bias", 25600, 3072, 768, 0),
         ("fc2_res", 25600, 768, 3072, 2))
EPI_NAMES = {3: "fc1_train_erf", 4: "fc1_train_tanh", 1: "fc1_gelu",
             0: "fc1_bias", 2: "fc2_res"}
_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _build(tree: str) -> str:
    sys.path.insert(0, os.path.abspath(tree))
    from vit_spoof_detection_pda_tpu_torch.ops import _build as b
    out = os.path.join(os.path.abspath(tree), "build", "stamps")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libgemm_stamps.so")
    src = os.path.join(os.path.dirname(b.__file__), "..", "csrc", "gemm.cu")
    subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-DVSD_GEMM_STAMPS", "-o", lib,
                    src], check=True, capture_output=True, text=True)
    return lib


def _sass(lib: str) -> dict:
    """For each stamped instantiation: the epilogue's instructions (between
    its 2nd and 3rd clock reads, in address order) and top opcodes."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass):
        name = func.split("\n", 1)[0]
        m = re.search(r"gemm_tma_kernelILi(\d)E", name)
        if not m:
            continue
        lines = [ln for ln in func.splitlines() if _LINE.match(ln)]
        clocks = [i for i, ln in enumerate(lines) if "SR_CLOCKLO" in ln]
        if len(clocks) < 4:
            continue
        body = lines[clocks[2] + 1:clocks[3]]
        ops = collections.Counter(_LINE.match(ln).group(3).split(".")[0]
                                  for ln in body)
        out[EPI_NAMES[int(m.group(1))]] = {
            "instructions": len(body), "per_element": len(body) / 128,
            "top": dict(ops.most_common(12))}
    return out


def _child(tree: str) -> None:
    import numpy as np
    import torch

    lib_path = _build(tree)
    lib = ctypes.CDLL(lib_path)
    fn = lib.vsd_gemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    get = lib.vsd_gemm_stamps
    get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    layout = (ctypes.c_int * 3)()
    get(None, 0, layout)
    blocks, per = layout[0], layout[2]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0, dt=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dt)

    res = {"tree": tree, "cases": {}}
    stream = torch.cuda.current_stream().cuda_stream
    for label, m, n, k, epi in CASES:
        a, w = t(m, k), t(k, n, scale=k ** -0.5)
        bias = t(n, scale=0.1, dt=torch.float32)
        r = t(m, n) if epi == 2 else None
        c = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        h = torch.empty_like(c) if epi >= 3 else None

        def launch():
            err = fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                     r.data_ptr() if r is not None else None, c.data_ptr(),
                     h.data_ptr() if h is not None else None, m, n, k, epi,
                     0, stream)
            assert err == 0, err
        times = []
        for _ in range(3):
            launch()
        for _ in range(5):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            launch()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        buf = (ctypes.c_ulonglong * (blocks * 2 * per))()
        assert get(buf, len(buf), None) == len(buf)
        st = np.frombuffer(buf, dtype=np.uint64).astype(np.int64).reshape(
            blocks, 2, per)
        tiles = -(-m // 128) * -(-n // 256)
        grid = min(tiles, sms)
        prod, epil, share = [], [], []
        for b in range(min(grid, blocks)):
            walk = len(range(b, tiles, grid))
            for wg in range(2):
                row = st[b, wg]
                ns_per_clk = (row[2] - row[0]) / max(1, row[3] - row[1])
                tt = row[4:4 + 3 * walk].reshape(walk, 3)
                p = (tt[:, 1] - tt[:, 0]) * ns_per_clk / 1e3
                q = (tt[:, 2] - tt[:, 1]) * ns_per_clk / 1e3
                prod += p.tolist()
                epil += q.tolist()
                share.append(q.sum() * 1e3 / max(1, row[2] - row[0]))
        res["cases"][label] = {
            "shape": [m, n, k], "tiles": tiles, "grid": grid,
            "products_us": [statistics.median(prod),
                            float(np.percentile(prod, 90))],
            "epilogue_us": [statistics.median(epil),
                            float(np.percentile(epil, 90))],
            "epilogue_share": statistics.median(share),
            "ms_stamped": statistics.median(times)}
        del a, w, bias, r, c, h
    res["epilogue_sass"] = _sass(lib_path)
    print(json.dumps(res))


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
