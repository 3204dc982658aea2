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
through the kernels.

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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("attention_block", "mlp_block", "attention_block_train",
           "attention_qkv_bwd", "ln_res_bwd", "lowlat_encoder",
           "lowlat_batchgrid", "pool_gather", "warp_pass", "nlm",
           "attention_qkv", "attention_block_f32", "attention_qkv_bwd_f32",
           "mlp_block_train", "attention_qkv_bwd_phased", "doctor_probe",
           "attention")
# one count per kernel form: each library's name, the int8 form of the
# per-item lowlat kernel ("lowlat_encoder_int8"), and the f32 forms that
# share a library with another form (the f32 training attention block is
# attention_block_f32's entry with its residual outputs; the LN backward,
# the training MLP block and the phased attention backward take bf16 or f32
# in one library)
LAUNCHES = {name: 0 for name in KERNELS + ("attention_block_train_f32",
                                           "ln_res_bwd_f32",
                                           "mlp_block_train_f32",
                                           "attention_qkv_bwd_phased_f32",
                                           "lowlat_encoder_int8",
                                           "attention_f32")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


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
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.vsd_error_string.argtypes = [ctypes.c_int]
            lib.vsd_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes):
    """``(library, C function)`` of kernel ``name``: the library loaded
    (built first if needed), the function's argument types set."""
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def check(lib: ctypes.CDLL, name: str, err: int):
    """Raise if a C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed: "
                           f"{lib.vsd_error_string(err).decode()} ({err})")
