"""The port's program cache (``utils/aot.py::cached_compile``) through
the cases of tests/test_aot.py, and its NaN switch
(``utils/determinism.py::enable_debug_nans``, JAX's ``jax_debug_nans``).

The cached program is compared with ``fn`` itself bit for bit: both run
the same operators on the same inputs on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.cli import doctor
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof
from vit_spoof_detection_pda_tpu_torch.ops import attention as att
from vit_spoof_detection_pda_tpu_torch.utils import aot
from vit_spoof_detection_pda_tpu_torch.utils.aot import cached_compile
from vit_spoof_detection_pda_tpu_torch.utils.determinism import (
    enable_debug_nans)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning",
                                        "ignore::FutureWarning")


def _fn(a, b):
    return torch.tanh(a @ b).sum(dim=1)


def _args(rows=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, 16, generator=g), torch.randn(16, 4, generator=g)


def _entries(d, key):
    return sorted(p for p in os.listdir(d)
                  if p.startswith(f"{key}-") and p.endswith(aot.SUFFIX))


def test_miss_then_hit_and_a_key_per_shape(tmp_path, monkeypatch):
    a, b = _args()
    exe1 = cached_compile(_fn, (a, b), key="t", cache_dir=str(tmp_path))
    want = _fn(a, b)
    assert torch.equal(exe1(a, b), want)
    assert len(_entries(tmp_path, "t")) == 1
    lowered = []
    real = torch.export.ExportedProgram.run_decompositions
    monkeypatch.setattr(torch.export.ExportedProgram, "run_decompositions",
                        lambda self, *a, **k: lowered.append(1) or real(
                            self, *a, **k))
    exe2 = cached_compile(_fn, (a, b), key="t", cache_dir=str(tmp_path))
    assert torch.equal(exe2(a, b), want) and lowered == []   # a hit
    assert exe2.hit and not exe1.hit
    a2, _ = _args(rows=4, seed=1)
    exe3 = cached_compile(_fn, (a2, b), key="t", cache_dir=str(tmp_path))
    assert torch.equal(exe3(a2, b), _fn(a2, b))
    assert len(_entries(tmp_path, "t")) == 2 and lowered == [1]
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".")]


def test_the_key_changes_with_the_program(tmp_path):
    a, b = _args()
    cached_compile(_fn, (a, b), key="p", cache_dir=str(tmp_path))
    exe = cached_compile(lambda x, y: torch.sigmoid(x @ y).sum(dim=1),
                         (a, b), key="p", cache_dir=str(tmp_path))
    assert len(_entries(tmp_path, "p")) == 2
    assert torch.equal(exe(a, b), torch.sigmoid(a @ b).sum(dim=1))
    scale = torch.full((4,), 2.0)
    cached_compile(lambda x, y: (x @ y * scale).sum(dim=1), (a, b), key="c",
                   cache_dir=str(tmp_path))
    scale.fill_(3.0)             # a held tensor's value is part of the key
    exe = cached_compile(lambda x, y: (x @ y * scale).sum(dim=1), (a, b),
                         key="c", cache_dir=str(tmp_path))
    assert len(_entries(tmp_path, "c")) == 2
    assert torch.equal(exe(a, b), (a @ b * 3.0).sum(dim=1))


def test_a_corrupt_entry_falls_back(tmp_path):
    a, b = _args()
    cached_compile(_fn, (a, b), key="c", cache_dir=str(tmp_path))
    (path,) = _entries(tmp_path, "c")
    (tmp_path / path).write_bytes(b"garbage")
    exe = cached_compile(_fn, (a, b), key="c", cache_dir=str(tmp_path))
    assert torch.equal(exe(a, b), _fn(a, b))
    # the bad entry was replaced by a good one
    assert cached_compile(_fn, (a, b), key="c",
                          cache_dir=str(tmp_path))._module is not None


def test_an_unusable_directory_builds_uncached(tmp_path):
    a, b = _args()
    blocker = tmp_path / "file"
    blocker.write_text("x")
    exe = cached_compile(_fn, (a, b), key="u",
                         cache_dir=str(blocker / "sub"))
    assert torch.equal(exe(a, b), _fn(a, b))
    ro = tmp_path / "ro"
    ro.mkdir()
    ro.chmod(0o500)
    try:
        exe = cached_compile(_fn, (a, b), key="u", cache_dir=str(ro))
        assert torch.equal(exe(a, b), _fn(a, b))
        assert os.listdir(ro) == [] or os.geteuid() == 0
    finally:
        ro.chmod(0o700)


def test_a_type_error_at_call_time_is_raised_not_retried(tmp_path,
                                                        monkeypatch):
    a, b = _args()
    exe = cached_compile(_fn, (a, b), key="e", cache_dir=str(tmp_path))
    lowered = []
    monkeypatch.setattr(torch.export.ExportedProgram, "run_decompositions",
                        lambda self, *a, **k: lowered.append(1))
    with pytest.raises(TypeError, match="signature"):
        exe(a[:4], b)
    with pytest.raises(TypeError):
        exe(a.double(), b)
    assert lowered == [] and exe._module is not None


def test_a_call_time_failure_falls_back_to_a_fresh_lowering(tmp_path):
    a, b = _args()
    exe = cached_compile(_fn, (a, b), key="f", cache_dir=str(tmp_path))

    def broken(*args):
        raise RuntimeError("stale program")

    exe._module = broken
    assert torch.equal(exe(a, b), _fn(a, b))
    assert exe._module is None and exe._fresh is not None


def test_the_trace_runs_on_a_hit_too(tmp_path):
    """As in JAX, a hit skips the lowering, not the trace, where the
    wrappers' dispatch logic and accounting run."""
    traced = []
    qkv = torch.randn(2, 8, 3 * 16)

    def fn(x):
        traced.append(x.shape)
        return att.dispatch_attention_qkv(x, 2)

    cached_compile(fn, (qkv,), key="s", cache_dir=str(tmp_path))
    exe = cached_compile(fn, (qkv,), key="s", cache_dir=str(tmp_path))
    assert exe.hit and len(traced) == 2
    assert torch.equal(exe(qkv), att.dispatch_attention_qkv(qkv, 2))


def test_doctor_reports_the_program_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(aot, "DEFAULT_CACHE_DIR", str(tmp_path / "aot"))
    (r,) = doctor.run_doctor(["compile_cache"])
    assert r["status"] == doctor.OK and r["aot_dir"] == str(tmp_path / "aot")
    assert r["aot_entries"] == 0
    blocker = tmp_path / "f"
    blocker.write_text("x")
    monkeypatch.setattr(aot, "DEFAULT_CACHE_DIR", str(blocker / "aot"))
    (r,) = doctor.run_doctor(["compile_cache"])
    assert r["status"] == doctor.WARN and "program cache" in r["note"]


# --------------------------------------------------------------------------
# enable_debug_nans
# --------------------------------------------------------------------------

def _model():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return ViTAntiSpoof(embed_dim=32, depth=1, num_heads=2, hidden=8,
                            patch_size=8, img_size=32, dropout=0.0)


def test_debug_nans_raise_in_the_forward():
    m = _model()
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    x[0, 0, 0, 0] = np.inf               # LayerNorm of an inf row -> NaN
    x = torch.from_numpy(x)
    assert torch.isnan(m(x)).any()       # off: NaN flows through
    enable_debug_nans()
    try:
        with pytest.raises(FloatingPointError, match="nan"):
            m(x)
        assert torch.isfinite(m(x[1:])).all()
    finally:
        enable_debug_nans(False)


def test_debug_nans_raise_in_the_backward():
    w = torch.zeros(3, requires_grad=True)
    enable_debug_nans()
    try:
        loss = (torch.sqrt(w) * 0).sum()       # forward finite
        with pytest.raises(FloatingPointError, match="nan"):
            loss.backward()                    # 0 * inf in the backward
    finally:
        enable_debug_nans(False)


def test_debug_nans_turn_off_and_restore_the_anomaly_setting():
    torch.autograd.set_detect_anomaly(False)
    enable_debug_nans()
    enable_debug_nans()                          # twice: one mode
    assert torch.is_anomaly_enabled()
    enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
    w = torch.zeros(3, requires_grad=True)
    (torch.sqrt(w) * 0).sum().backward()         # no raise when off
    assert torch.isnan(w.grad).all()
    enable_debug_nans(False)                     # off twice: a no-op
