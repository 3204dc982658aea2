"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), then loaded with ``ctypes``.  Libraries go to
``build/kernels/<hash>/`` at the root of the checkout (``.gitignore``
lists ``build/``), keyed on a hash of every source in ``csrc/`` and of
the flags, and are built at first use; a library already built for the
same hash is reused.  A failed build raises with nvcc's stderr.

:data:`LAUNCHES` holds one count per kernel form (a library, or an f32
form beside a bf16 one): each wrapper adds one where it launches its
kernel and nowhere else, so a run can show that its main path went
through the kernels.  The GEMM cores inside the block kernels count their
own launches in C, where their launchers launch them
(:func:`core_launches`).

Nothing here runs when the module is imported, so the CPU tests, which
have no ``nvcc``, import it freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.profiling import annotate

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("attention_block", "mlp_block", "attention_block_train",
           "attention_bwd_onchip", "ln_res_bwd", "lowlat_encoder",
           "lowlat_batchgrid", "pool_gather", "warp_pass", "nlm",
           "attention_qkv", "attention_block_f32", "mlp_block_train",
           "doctor_probe", "attention", "attention_cp",
           "attention_bwd_tiled", "gemm")
# one count per kernel form: each library's name but attention_bwd_onchip's,
# whose entry points count under their kernels' names (kernels 4, 5 and 13:
# "attention_qkv_bwd", "attention_qkv_bwd_phased", "attention_cp_bwd"), the
# int8 form of the per-item lowlat kernel ("lowlat_encoder_int8"), the f32
# forms that share a library with another form (the f32 training attention
# block is attention_block_f32's entry with its residual outputs; the LN
# backward, the training MLP block and the attention backwards, kernels 4, 5
# and 13, take bf16 or f32 in one library), and the key-tiled routes past
# what a block holds: the key-tiled backward on the fused projection
# (kernels 4 and 5, "attention_bwd_tiled") and on kernel 13's rectangle
# ("attention_cp_bwd_tiled"), the key-tiled forward cores under each of
# their four callers (bf16: kernel 12's key tiles; f32: attention_f32.cuh),
# kernel 12's key-tiled form, and the standalone GEMM entry's f32 core
# ("gemm_f32", beside "gemm", its bf16 core)
LAUNCHES = {name: 0 for name in tuple(
    n for n in KERNELS if n != "attention_bwd_onchip") + (
                                           "attention_qkv_bwd",
                                           "attention_qkv_bwd_phased",
                                           "attention_cp_bwd",
                                           "attention_block_train_f32",
                                           "attention_qkv_bwd_f32",
                                           "ln_res_bwd_f32",
                                           "mlp_block_train_f32",
                                           "attention_qkv_bwd_phased_f32",
                                           "lowlat_encoder_int8",
                                           "attention_f32",
                                           "attention_cp_f32",
                                           "attention_cp_bwd_f32",
                                           "attention_bwd_tiled_f32",
                                           "attention_cp_bwd_tiled",
                                           "attention_cp_bwd_tiled_f32",
                                           "attention_block_tiled",
                                           "attention_block_train_tiled",
                                           "attention_qkv_tiled",
                                           "attention_tiled",
                                           "attention_block_f32_tiled",
                                           "attention_block_train_f32_tiled",
                                           "attention_qkv_f32_tiled",
                                           "attention_f32_tiled",
                                           "attention_cp_tiled",
                                           "attention_cp_tiled_f32",
                                           "gemm_f32")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
# (library name, symbol) -> (library, bound C function, argtypes as first
# asked for)
_entries: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (neither on PATH nor in "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built on this machine")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return _build_dir() / f"lib{name}.so"


def build_log(name: str) -> str:
    """nvcc's output for the last build of ``name`` (ptxas's register and
    shared-memory report among it), or '' if it was not built here."""
    log = _build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


def build(names=KERNELS) -> list:
    """Compile every named kernel that is not built yet: one ``nvcc`` per
    source, all started together.  Returns the names it compiled."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        (out_dir / f"{name}.log").write_text(stdout + stderr)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.  The
    first load of each library (the sources' hash, nvcc where it is not
    built, the ``ctypes`` load) runs in the span ``vsd.kernels.load``,
    whose profiler args name the library."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with annotate("vsd.kernels.load", name):
                build((name,))
                lib = ctypes.CDLL(str(library_path(name)))
            lib.vsd_error_string.argtypes = [ctypes.c_int]
            lib.vsd_error_string.restype = ctypes.c_char_p
            lib.vsd_core_launches.argtypes = [
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
            lib.vsd_core_launches.restype = None
            _libs[name] = lib
        return lib


def core_launches(reset: bool = False) -> dict:
    """The GEMM cores' launches, ``{"gemm": bf16, "gemm_f32": f32}``,
    summed over every loaded library: each library counts them in C where
    ``launch_gemm`` (``csrc/gemm_core.cuh``) or ``launch_gemm_f32``
    (``csrc/f32_common.cuh``) launches its kernel (``vsd_core_launches``).
    The block kernels 1, 2, 3 and 7 launch a core twice a call, the
    standalone entry (``ops/gemm.py::gemm``) once.  ``reset`` zeroes the
    counts after reading them."""
    total = [0, 0]
    with _lock:
        libs = list(_libs.values())
    for lib in libs:
        out = (ctypes.c_longlong * 2)()
        lib.vsd_core_launches(out, int(reset))
        total[0] += out[0]
        total[1] += out[1]
    return {"gemm": total[0], "gemm_f32": total[1]}


def entry(name: str, symbol: str, argtypes):
    """``(library, C function)`` of kernel ``name``: the library loaded
    (built first if needed), the function bound with ``argtypes`` and an
    int return.  Each ``(name, symbol)`` is resolved and bound once, under
    the lock; later calls are one dictionary lookup, and one that asks for
    other ``argtypes`` raises ``ValueError``."""
    hit = _entries.get((name, symbol))
    if hit is None:
        lib = load(name)
        with _lock:
            hit = _entries.get((name, symbol))
            if hit is None:
                fn = getattr(lib, symbol)
                fn.argtypes = tuple(argtypes)
                fn.restype = ctypes.c_int
                hit = _entries[(name, symbol)] = (lib, fn, argtypes)
    if hit[2] is not argtypes and tuple(hit[1].argtypes) != tuple(argtypes):
        raise ValueError(f"{symbol} of {name} is bound with argtypes "
                         f"{hit[1].argtypes}; asked for {tuple(argtypes)}")
    return hit[0], hit[1]


def check(lib: ctypes.CDLL, name: str, err: int):
    """Raise if a C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed: "
                           f"{lib.vsd_error_string(err).decode()} ({err})")
