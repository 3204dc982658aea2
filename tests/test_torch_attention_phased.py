"""The phase-split attention backward (table row 5: JAX
``ops/attention.py::_attn_qkv_bwd_kernel_phased``, the port's
``csrc/attention_qkv_bwd_phased.cu``) on the CPU: the port's
``attention_qkv_bwd`` with ``BWD_PHASED`` set (its plain version here)
against JAX's ``_backward_qkv`` with its ``BWD_PHASED`` set, the Pallas
kernel in interpret mode, on numpy-seeded inputs with zero pad rows.

Bounds: 2e-6 at f32 (the same f32 products and softmax, summed in other
orders) and 2 bf16 ulps of each output's largest magnitude at bf16 (both
round w and dl to bf16 at the same points; a rounding can land one ulp
apart).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.ops import attention as jatt
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt


@pytest.fixture
def phased(monkeypatch):
    """Both packages' flags set for the test and restored after (JAX reads
    its flag when it traces: each call below is a fresh, un-jitted
    trace)."""
    monkeypatch.setattr(jatt, "BWD_PHASED", True)
    monkeypatch.setattr(tatt, "BWD_PHASED", True)


def _inputs(seed, b, tp, valid, d):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, tp, 3 * d)).astype(np.float32)
    g = rng.standard_normal((b, tp, d)).astype(np.float32)
    g[:, valid:] = 0
    return qkv, g


def _bf16_ulps(want, ulps=2):
    amax = float(np.abs(want).max())
    return ulps * 2.0 ** (math.floor(math.log2(amax)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tp,valid,d,heads", [
    (2, 16, 13, 32, 2),       # ragged keys, three pad rows
    (3, 24, 24, 64, 4),       # no padding, odd B
    (2, 40, 33, 64, 4),       # the ragged shape of the card's checks
])
def test_phased_backward_matches_jax_phased_kernel(phased, dtype, b, tp,
                                                   valid, d, heads):
    qkv, g = _inputs(b * tp + d, b, tp, valid, d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jatt._backward_qkv(
        jnp.asarray(qkv, jdt), jnp.asarray(g, jdt), heads, interpret=True,
        valid_len=valid).astype(jnp.float32))
    got = tatt.attention_qkv_bwd(torch.tensor(qkv, dtype=tdt),
                                 torch.tensor(g, dtype=tdt), heads,
                                 valid_len=valid).float().numpy()
    assert got.shape == want.shape == (b, tp, 3 * d)
    assert (got[:, valid:] == 0).all() and (want[:, valid:] == 0).all()
    for i in range(3):                           # dq, dk, dv
        w, o = want[..., i * d:(i + 1) * d], got[..., i * d:(i + 1) * d]
        tol = 2e-6 if dtype == "float32" else _bf16_ulps(w)
        np.testing.assert_allclose(o, w, rtol=0, atol=tol)


def test_phased_kernel_equals_jax_unphased_kernel(phased):
    """JAX's docstring: the phased kernel's numerics are kernel 4's (the
    same dots, the same rounding points) — here at bf16, in interpret
    mode, bit for bit; so the port's one plain version serves both."""
    qkv, g = _inputs(3, 2, 16, 13, 32)
    args = (jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), 2)
    ph = np.asarray(jatt._backward_qkv(*args, interpret=True, valid_len=13)
                    .astype(jnp.float32))
    jatt.BWD_PHASED = False          # the fixture restores it
    base = np.asarray(jatt._backward_qkv(*args, interpret=True, valid_len=13)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(ph, base)


def test_flag_on_the_cpu_runs_the_plain_version(phased):
    qkv, g = (torch.tensor(a) for a in _inputs(4, 2, 16, 13, 32))
    before = dict(tatt.LAUNCHES)
    got = tatt.attention_qkv_bwd(qkv, g, 2, valid_len=13)
    assert torch.equal(got, tatt.attention_qkv_bwd_plain(qkv, g, 2,
                                                          valid_len=13))
    assert torch.equal(got, tatt.attention_qkv_bwd_phased(qkv, g, 2,
                                                           valid_len=13))
    assert tatt.LAUNCHES == before


def test_phased_chunk_keeps_the_workspace_in_l2():
    assert tatt.phased_chunk(128, 12, 200) == 16     # 30.7 MB at ViT-B
    assert tatt.phased_chunk(3, 12, 200) == 3
    assert tatt.phased_chunk(4, 12, 4000) == 1       # one item over budget
    assert 16 * 12 * 200 * 200 * 4 <= tatt._PHASED_WORKSPACE_BYTES
