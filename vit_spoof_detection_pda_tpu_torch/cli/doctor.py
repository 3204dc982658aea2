"""`doctor` command (JAX ``cli/doctor.py``): environment self-check of
the port, bottom-up, each check reporting ok / warn / fail with the
remedy, so a machine can be validated before a training or serving job.

The checks keep the JAX names, so ``--only`` lists carry over: the
``pallas`` check builds and launches the port's toolchain probe
(``csrc/doctor_probe.cu``, kernel 17), ``native_codec`` builds the host
codec (``data/native``) and decodes a PNG back, and ``compile_cache`` is
the kernels' build directory and the program cache (``utils/aot.py``).
Without a card, the device checks warn.

Exit code 0 when nothing fails (warnings allowed), 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

OK, WARN, FAIL = "ok", "warn", "fail"


def _check(name):
    def deco(fn):
        fn._check_name = name
        return fn
    return deco


def _nvcc_version():
    from ..ops import _build
    try:
        out = subprocess.run([_build._nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else None


@_check("versions")
def check_versions():
    import numpy
    import torch

    return OK, {
        "python": sys.version.split()[0],
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "nvcc": _nvcc_version(), "numpy": numpy.__version__,
    }


@_check("backend")
def check_backend():
    import torch

    if torch.cuda.is_available():
        return OK, {"backend": "cuda",
                    "devices": [torch.cuda.get_device_name(i)
                                for i in range(torch.cuda.device_count())],
                    "count": torch.cuda.device_count()}
    return WARN, {"backend": "cpu", "devices": [], "count": 0,
                  "note": "no CUDA card: the verbs run only with --device "
                          "cpu, on the kernels' plain PyTorch versions"}


@_check("device_exec")
def check_device_exec():
    import torch

    card = torch.cuda.is_available()
    dev = torch.device("cuda" if card else "cpu")
    t0 = time.perf_counter()
    a = torch.ones((128, 128), dtype=torch.bfloat16, device=dev)
    val = float((a @ a).float().sum())
    dt = time.perf_counter() - t0
    if val != 128.0 ** 3:
        return FAIL, {"error": f"wrong result {val}"}
    if not card:
        return WARN, {"note": "no CUDA card: the product ran on the CPU",
                      "exec_s": round(dt, 2)}
    return OK, {"exec_s": round(dt, 2)}


@_check("device_memory")
def check_device_memory():
    from ..utils.profiling import device_memory_gb

    mem = device_memory_gb()
    if mem is None:
        return WARN, {"note": "no CUDA card — train/device_mem_gb "
                              "telemetry disabled"}
    return OK, {"bytes_in_use_gb": round(mem, 3)}


@_check("mesh")
def check_mesh():
    """The process group (world size, backend; one rank without one), the
    mesh ``parallel/mesh.py::mesh_from_config`` would build over it from
    the default config and, over several ranks, a summed all-reduce."""
    import torch

    from ..config import Config
    from ..parallel import mesh as pmesh

    n = pmesh.world_size()
    shape = pmesh.config_layout(Config().sharding, n)
    backend = None
    if n > 1:
        import torch.distributed as dist
        backend = dist.get_backend()
        dev = "cuda" if backend == "nccl" else "cpu"
        x = torch.tensor([float(pmesh.rank())], device=dev)
        dist.all_reduce(x)
        if x.item() != n * (n - 1) / 2:
            return FAIL, {"error": "all-reduce over the ranks mismatched"}
    info = {"world_size": n, "backend": backend,
            "devices": torch.cuda.device_count(), "mesh": shape,
            "note": "data, sequence and tensor parallelism, FSDP and the "
                    "pipeline run one process per rank (torchrun)"}
    return (OK if torch.cuda.is_available() else WARN), info


@_check("pallas")
def check_pallas():
    import torch

    from ..ops import probe

    card = torch.cuda.is_available()
    if card:
        from ..ops import _build
        try:
            _build._nvcc()
        except RuntimeError:
            card = False
    x = torch.ones((8, 128), dtype=torch.float32,
                   device="cuda" if card else "cpu")
    out = probe.doctor_probe(x)
    if float(out.sum()) != 2.0 * x.numel():
        return FAIL, {"error": "probe kernel wrong result"}
    if not card:
        return WARN, {"note": "no CUDA card or no nvcc: the probe ran its "
                              "plain version (kernel build unverified)"}
    return OK, {"kernel": "csrc/doctor_probe.cu", "built_for": "sm_90a"}


@_check("native_codec")
def check_native_codec():
    """The libjpeg/libpng codec (``data/native``) builds, and decodes a
    PNG back bit for bit.  The PNG is written with the standard library,
    so the check needs no PIL."""
    import tempfile

    import numpy as np

    from ..data import native

    lib = native.get_lib()
    if lib is None:
        return WARN, {"note": "C++ codec unavailable (PIL fallback "
                              "active); check g++/libjpeg-dev/libpng-dev "
                              "— data/native builds on first use",
                      "build_error": native.build_error()}
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(native.encode_png(img))
        f.flush()
        arr = native.native_decode(f.name, 32, resize="exact")
    if arr is None or arr.shape != (32, 32, 3):
        return FAIL, {"error": "native decode returned wrong shape"}
    if not np.array_equal(arr, img):
        return FAIL, {"error": "native PNG decode not bit-exact vs source"}
    return OK, {"png_roundtrip": "bit-exact",
                "library": str(native.library_path())}


def _writable(d) -> str:
    """'' if a file can be written in ``d`` (made if missing), else the
    error."""
    import os

    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, ".doctor_probe")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
    except OSError as e:
        return str(e)
    return ""


@_check("compile_cache")
def check_compile_cache():
    """The kernels' build directory (``ops/_build.py``) and the program
    cache (``utils/aot.py``)."""
    import os

    from ..ops import _build
    from ..utils import aot

    d, a = _build._build_dir(), aot.DEFAULT_CACHE_DIR
    err = _writable(d)
    if err:
        return WARN, {"note": f"kernel build dir not writable ({err}); "
                              "every run will fail to build the kernels"}
    info = {"dir": str(d), "entries": len(
        [f for f in os.listdir(d) if not f.startswith(".")])}
    err = _writable(a)
    if err:
        return WARN, {**info, "note": f"program cache dir not writable "
                                      f"({err}); cold starts will re-lower"}
    return OK, {**info, "aot_dir": a, "aot_entries": len(
        [f for f in os.listdir(a) if not f.startswith(".")])}


@_check("config_presets")
def check_config_presets():
    from ..config import PRESETS, Config

    built = {}
    for name in PRESETS:
        cfg = Config.preset(name)
        built[name] = cfg.model.name
    return OK, {"presets": built}


CHECKS = [check_versions, check_backend, check_device_exec,
          check_device_memory, check_mesh, check_pallas,
          check_native_codec, check_compile_cache, check_config_presets]


def run_doctor(names=None) -> list:
    if names:
        known = {fn._check_name for fn in CHECKS}
        unknown = sorted(set(names) - known)
        if unknown:
            # a typo must not filter every check out and report "ok"
            raise ValueError(
                f"unknown check name(s) {unknown}; known: {sorted(known)}")
    results = []
    for fn in CHECKS:
        name = fn._check_name
        if names and name not in names:
            continue
        try:
            status, detail = fn()
        except Exception as e:  # noqa: BLE001 - each probe must not kill the rest
            status, detail = FAIL, {"error": f"{type(e).__name__}: {e}"}
        results.append({"check": name, "status": status, **detail})
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Validate the environment end to end (card, "
                    "kernels, build directory, config)")
    parser.add_argument("--json", action="store_true",
                        help="one JSON object per check")
    parser.add_argument("--only", nargs="*", default=None,
                        help="subset of checks to run")
    args = parser.parse_args(argv)

    try:
        results = run_doctor(args.only)
    except ValueError as e:
        parser.error(str(e))
    worst = OK
    for r in results:
        if args.json:
            print(json.dumps(r))
        else:
            head = {"ok": "  ok ", "warn": " WARN", "fail": " FAIL"}[
                r["status"]]
            detail = {k: v for k, v in r.items()
                      if k not in ("check", "status")}
            print(f"[{head}] {r['check']}: {detail}")
        if r["status"] == FAIL or (r["status"] == WARN and worst == OK):
            worst = r["status"]
    if not args.json:
        print(f"doctor: {worst}" + (
            "" if worst == OK else " (see above)"))
    if any(r["status"] == FAIL for r in results):
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
