"""Kernel 14's wrapper (``ops/gather.py::pool_gather``) against the JAX
package's Pallas gather, and the port's binding of C entry points
(``ops/_build.py::entry``), on the CPU.

- on a CPU pool the wrapper runs its plain version; it equals
  ``ops/gather_pallas.py::pool_gather`` (Pallas, interpret mode) exactly,
  with repeated indices, at B = 1, 128 and 300 rows of 16, 105, 3,072 and
  150,528 bytes (a 224 x 224 x 3 face) and of f32;
- ``_build.entry`` resolves and binds a symbol once, also when threads
  ask for it together, and refuses other argument types for it (on the C
  library, in place of a kernel's).

The card holds the kernel itself to the plain version
(``tests/test_torch_kernels_cuda.py``).
"""

import ctypes
import ctypes.util
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.ops.gather_pallas import pool_gather as j_gather
from vit_spoof_detection_pda_tpu_torch.ops import _build
from vit_spoof_detection_pda_tpu_torch.ops import gather as TG


@pytest.mark.parametrize("shape,dtype,b", [
    ((3, 224, 224, 3), np.uint8, 1),   # faces of 150,528 bytes
    ((3, 224, 224, 3), np.uint8, 4),
    ((40, 32, 32, 3), np.uint8, 50),   # 3 KB rows
    ((1000, 16), np.uint8, 300),       # 16-byte rows
    ((37, 5, 7, 3), np.uint8, 128),    # 105-byte rows
    ((37, 8, 16, 3), np.uint8, 128),
    ((11, 2, 128), np.float32, 128),   # f32 rows
    ((11, 2, 128), np.float32, 1),
])
def test_pool_gather_equals_jax_pallas_with_repeats(shape, dtype, b):
    rng = np.random.default_rng(7)
    pool = (rng.integers(0, 256, shape).astype(dtype) if dtype == np.uint8
            else rng.standard_normal(shape).astype(dtype))
    idx = rng.integers(0, shape[0], b).astype(np.int32)
    idx[1::3] = idx[0]                  # repeated indices
    want = np.asarray(j_gather(jnp.asarray(pool), jnp.asarray(idx),
                               interpret=True))
    n0 = TG.LAUNCHES["pool_gather"]
    got = TG.pool_gather(torch.from_numpy(pool), idx)
    assert TG.LAUNCHES["pool_gather"] == n0      # no launch on the CPU
    np.testing.assert_array_equal(got.numpy(), want)


class _CountingLib:
    """The C library with its symbol lookups counted."""

    def __init__(self):
        self.lib = ctypes.CDLL(ctypes.util.find_library("c"))
        self.lookups = 0

    def __getattr__(self, symbol):
        self.lookups += 1
        return getattr(self.lib, symbol)


@pytest.fixture
def libc(monkeypatch):
    """``_build.load`` on the C library, with an empty entry cache; the
    library and the names it was loaded under."""
    lib, loads = _CountingLib(), []

    def load(name):
        loads.append(name)
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_entries", {})
    return lib, loads


def test_entry_binds_each_symbol_once(libc):
    lib, loads = libc
    sig = (ctypes.c_int,)
    got_lib, fn = _build.entry("libc", "abs", sig)
    assert got_lib is lib and fn(-3) == 3
    assert fn.argtypes == sig and fn.restype is ctypes.c_int
    for argtypes in (sig, [ctypes.c_int], (ctypes.c_int,)):
        again = _build.entry("libc", "abs", argtypes)
        assert again[0] is lib and again[1] is fn
    assert loads == ["libc"] and lib.lookups == 1
    # argtypes are set once: a later entry leaves the bound function alone
    fn.argtypes = (ctypes.c_long,)
    assert _build.entry("libc", "abs", sig)[1].argtypes == (ctypes.c_long,)
    fn.argtypes = sig
    # another symbol of the same library is bound on its own
    _, labs = _build.entry("libc", "labs", (ctypes.c_long,))
    assert labs is not fn and lib.lookups == 2


@pytest.mark.parametrize("other", [(ctypes.c_long,),
                                   (ctypes.c_int, ctypes.c_int), ()])
def test_entry_refuses_other_argtypes(libc, other):
    _build.entry("libc", "abs", (ctypes.c_int,))
    with pytest.raises(ValueError, match="argtypes"):
        _build.entry("libc", "abs", other)
    # the binding stays as first asked for
    assert _build.entry("libc", "abs", (ctypes.c_int,))[1](-5) == 5


def test_entry_binds_once_across_threads(libc):
    lib, _ = libc
    sig = (ctypes.c_int,)
    start, got = threading.Barrier(8), []

    def bind():
        start.wait()
        got.append(_build.entry("libc", "abs", sig)[1])

    threads = [threading.Thread(target=bind) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and all(fn is got[0] for fn in got)
    assert lib.lookups == 1
