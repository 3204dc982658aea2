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


# (dtype, b, tp, heads, dh) -> route, the instance / chunk, shared memory
# (bf16: Q and G in tiles of their own where they fit beside K, V, w and
# dl): each on-chip instance at its largest Tp and one past it, the f32
# instances and bound,
# the head dims the one launch does not take, the old long route's largest
# Tp and one past it (which that route refused); every other shape runs
# the key-tiled backward
BF, F32 = torch.bfloat16, torch.float32
PLANS = [
    ((BF, 128, 200, 12, 64), {"route": "on_chip", "keys": 208, "warps": 7,
                              "smem": 226304}),
    ((BF, 2, 64, 4, 16), {"route": "on_chip", "keys": 64, "warps": 4,
                          "smem": 24576}),
    ((BF, 2, 65, 4, 16), {"route": "on_chip", "keys": 128, "warps": 5,
                          "smem": 35840}),
    ((BF, 2, 128, 4, 32), {"route": "on_chip", "keys": 128, "warps": 7,
                           "smem": 98304}),
    ((BF, 2, 129, 4, 32), {"route": "on_chip", "keys": 208, "warps": 7,
                           "smem": 119808}),
    ((BF, 1, 208, 12, 64), {"route": "on_chip", "keys": 208, "warps": 7,
                            "smem": 226304}),
    ((BF, 1, 209, 12, 64), {"route": "key_tiled", "warps": 4, "tile": 64,
                            "smem": 38912}),
    ((BF, 3, 208, 4, 16), {"route": "on_chip", "keys": 208, "warps": 7,
                           "smem": 199680}),
    ((BF, 3, 209, 4, 16), {"route": "key_tiled", "warps": 4, "tile": 64,
                           "smem": 14336}),
    ((BF, 2, 40, 2, 128), {"route": "key_tiled", "warps": 4, "tile": 64,
                           "smem": 71680}),
    ((F32, 32, 200, 12, 64), {"route": "on_chip", "keys": 256, "warps": 8,
                              "smem": 151808}),
    ((F32, 1, 256, 12, 64), {"route": "on_chip", "keys": 256, "warps": 8,
                             "smem": 189440}),
    ((F32, 1, 257, 12, 64), {"route": "on_chip", "keys": 320, "warps": 8,
                             "smem": 192128}),
    ((F32, 1, 320, 12, 64), {"route": "on_chip", "keys": 320, "warps": 8,
                             "smem": 232448}),
    ((F32, 1, 321, 12, 64), {"route": "key_tiled", "warps": 8, "tile": 32,
                             "smem": 76800}),
    ((F32, 2, 40, 2, 48), {"route": "key_tiled", "warps": 8, "tile": 32,
                           "smem": 68608}),
    ((BF, 128, 908, 12, 64), {"route": "key_tiled", "warps": 4, "tile": 64,
                              "smem": 38912}),
    ((F32, 128, 400, 12, 64), {"route": "key_tiled", "warps": 8, "tile": 32,
                               "smem": 76800}),
    ((BF, 2, 909, 4, 64), {"route": "key_tiled", "warps": 4, "tile": 64,
                           "smem": 38912}),
    ((F32, 2, 909, 4, 64), {"route": "key_tiled", "warps": 8, "tile": 32,
                            "smem": 76800}),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_phased_plan_at_the_instance_boundaries(shape, want):
    dtype, b, tp, heads, dh = shape
    assert tatt.phased_plan(b, tp, heads, dh, dtype) == want
    if want["route"] == "key_tiled":          # Tp does not enter the plan
        assert tatt.phased_plan(b, 4 * tp, heads, dh, dtype) == want


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("tp,dh,limit", [
    (200, 72, "multiple of 16 from 16 to 128"),
    (200, 144, "multiple of 16 from 16 to 128"),
])
def test_phased_plan_names_the_limit(dtype, tp, dh, limit):
    with pytest.raises(ValueError, match=limit):
        tatt.phased_plan(2, tp, 4, dh, dtype)
