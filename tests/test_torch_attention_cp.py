"""Kernels 12 and 13's plain versions (the sequence-parallel rectangular
attention forward and backward, ``ops/attention.py``) against the JAX
package's ``fused_attention_qkv_cp`` (its Pallas kernels in interpret
mode), its dense oracle ``_cp_dense_reference`` and its custom VJP, on
the same numpy-seeded q and kv.

On the CPU ``fused_attention_qkv_cp`` runs the plain versions; the CUDA
kernels are held against those on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances:
- forward f32: atol 2e-5 / rtol 1e-5, JAX's own test of the kernel
  against its oracle (tests/test_sequence_parallel.py:35);
- forward bf16: 2 bf16 ulps of the largest output magnitude (the weights
  round to bf16 on both sides and a rounding that lands one ulp apart
  moves the output by about one ulp);
- backward f32: atol 1e-4 / rtol 1e-4 against ``jax.grad`` through JAX's
  custom VJP (JAX :54-68); bf16: 2 bf16 ulps of each output's largest
  magnitude (dq and dkv each).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.ops import attention as jatt
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (b, tq, tk, heads, dh, valid): JAX's shape, the odd shapes that pad both
# Tq and Tk, and the sequence-parallel step's block at ViT-B, two ranks
SHAPES = [(2, 25, 104, 4, 16, 100), (1, 5, 13, 2, 8, 13),
          (1, 33, 197, 2, 8, 197), (1, 8, 200, 2, 8, 197),
          (2, 104, 208, 12, 64, 197)]


def _pair(seed, b, tq, tk, heads, dh):
    rng = np.random.default_rng(seed)
    d = heads * dh
    return (rng.standard_normal((b, tq, d)).astype(np.float32),
            rng.standard_normal((b, tk, 2 * d)).astype(np.float32))


def _bf16_tol(want):
    amax = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,tq,tk,heads,dh,valid", SHAPES)
def test_plain_forward_matches_jax_kernel(dtype, b, tq, tk, heads, dh,
                                          valid):
    jdt, tdt = DTYPES[dtype]
    q, kv = _pair(tq * 100 + tk, b, tq, tk, heads, dh)
    jq, jkv = jnp.asarray(q, jdt), jnp.asarray(kv, jdt)
    want = np.asarray(jatt.fused_attention_qkv_cp(jq, jkv, heads, valid,
                                                  True), np.float32)
    got = tatt.fused_attention_qkv_cp(torch.tensor(q).to(tdt),
                                      torch.tensor(kv).to(tdt), heads, valid)
    assert got.dtype == tdt and tuple(got.shape) == (b, tq, heads * dh)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
        oracle = np.asarray(jatt._cp_dense_reference(jq, jkv, heads, valid))
        np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= _bf16_tol(want)


def _jax_grads(q, kv, g, heads, valid, jdt):
    def f(q_, kv_):
        return jatt.fused_attention_qkv_cp(q_, kv_, heads, valid, True)

    _, vjp = jax.vjp(f, jnp.asarray(q, jdt), jnp.asarray(kv, jdt))
    return [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g, jdt))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,tq,tk,heads,dh,valid",
                         [(2, 16, 48, 2, 16, 41), (2, 25, 104, 4, 16, 100),
                          (1, 33, 197, 2, 8, 197), (1, 8, 200, 2, 8, 197)])
def test_plain_backward_matches_jax_vjp(dtype, b, tq, tk, heads, dh, valid):
    jdt, tdt = DTYPES[dtype]
    q, kv = _pair(tq + 7 * tk, b, tq, tk, heads, dh)
    g = np.random.default_rng(tq).standard_normal(
        (b, tq, heads * dh)).astype(np.float32)
    want_dq, want_dkv = _jax_grads(q, kv, g, heads, valid, jdt)
    dq, dkv = tatt.attention_cp_bwd_plain(
        torch.tensor(q).to(tdt), torch.tensor(kv).to(tdt),
        torch.tensor(g).to(tdt), heads, valid)
    assert dq.dtype == dkv.dtype == tdt
    assert tuple(dkv.shape) == (b, tk, 2 * heads * dh)
    for got, want in ((dq.float().numpy(), want_dq),
                      (dkv.float().numpy(), want_dkv)):
        if dtype == "f32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        else:
            assert np.abs(got - want).max() <= _bf16_tol(want)
    # the masked (pad) keys: exactly zero dk and dv
    assert not dkv[:, valid:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_matches_plain_backward(dtype):
    """``fused_attention_qkv_cp``'s autograd on the CPU is the plain
    backward, bit for bit, and its pad keys get zero gradient."""
    tdt = DTYPES[dtype][1]
    b, tq, tk, heads, dh, valid = 2, 13, 40, 2, 16, 35
    q, kv = _pair(5, b, tq, tk, heads, dh)
    g = torch.tensor(np.random.default_rng(6).standard_normal(
        (b, tq, heads * dh)).astype(np.float32)).to(tdt)
    qt = torch.tensor(q).to(tdt).requires_grad_()
    kvt = torch.tensor(kv).to(tdt).requires_grad_()
    out = tatt.fused_attention_qkv_cp(qt, kvt, heads, valid)
    out.backward(g)
    dq, dkv = tatt.attention_cp_bwd_plain(qt.detach(), kvt.detach(), g,
                                          heads, valid)
    assert torch.equal(qt.grad, dq) and torch.equal(kvt.grad, dkv)
    assert not kvt.grad[:, valid:].any()


def test_square_block_equals_kernel_8_plain():
    """With every key local (one sequence rank) the rectangular forward
    and backward are kernel 8's and kernel 4's on the fused stream."""
    b, t, heads, dh = 2, 17, 4, 16
    d = heads * dh
    qkv = torch.tensor(np.random.default_rng(9).standard_normal(
        (b, t, 3 * d)).astype(np.float32))
    g = torch.tensor(np.random.default_rng(10).standard_normal(
        (b, t, d)).astype(np.float32))
    got = tatt.fused_attention_qkv_cp(qkv[..., :d], qkv[..., d:], heads, t)
    torch.testing.assert_close(got, tatt.fused_attention_qkv_plain(qkv, heads),
                               atol=1e-6, rtol=1e-6)
    dq, dkv = tatt.attention_cp_bwd_plain(qkv[..., :d], qkv[..., d:], g,
                                          heads, t)
    want = tatt.attention_qkv_bwd_plain(qkv, g, heads, valid_len=t)
    torch.testing.assert_close(torch.cat([dq, dkv], -1), want, atol=1e-6,
                               rtol=1e-6)


def test_shape_and_device_errors():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="kv has shape"):
        tatt.fused_attention_qkv_cp(q, torch.zeros(2, 16, 64), 4, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tatt.fused_attention_qkv_cp(q, torch.zeros(2, 16, 128), 5, 16)


# (dtype, tq, tk, dh) -> form, tiles, warps, shared memory: the one-pass
# limit (208 keys) and one key past it, the SP blocks of ViT-B/16, an
# uneven tiling with an idle warp, the largest Tk of each form whose K and
# V fit, and one past it (which the two-pass form refused): key tiles
CP_PLANS = [
    ((torch.bfloat16, 104, 208, 64), ("one_pass", 1, 7, 76032)),
    ((torch.bfloat16, 104, 209, 64), ("two_pass", 1, 7, 64512)),
    ((torch.bfloat16, 52, 208, 64), ("one_pass", 1, 4, 69120)),
    ((torch.bfloat16, 56, 224, 64), ("two_pass", 1, 4, 64512)),
    ((torch.bfloat16, 208, 208, 64), ("one_pass", 2, 7, 76032)),
    ((torch.bfloat16, 128, 208, 64), ("one_pass", 2, 4, 69120)),
    ((torch.bfloat16, 16, 800, 64), ("two_pass", 1, 1, 230400)),
    ((torch.bfloat16, 13, 416, 128), ("two_pass", 1, 1, 226304)),
    ((torch.float32, 104, 208, 64), ("one_pass", 1, 16, 188928)),
    ((torch.float32, 104, 209, 64), ("two_pass", 1, 8, 137984)),
    ((torch.float32, 200, 384, 64), ("two_pass", 2, 8, 229376)),
    ((torch.float32, 33, 112, 128), ("one_pass", 1, 16, 226816)),
    ((torch.float32, 33, 113, 128), ("two_pass", 1, 8, 147200)),
    ((torch.float32, 33, 200, 128), ("two_pass", 1, 8, 231680)),
    ((torch.bfloat16, 16, 801, 64), ("key_tiled", 1, 1, 73728)),
    ((torch.float32, 16, 385, 64), ("key_tiled", 1, 8, 90112)),
    ((torch.float32, 16, 201, 128), ("key_tiled", 1, 8, 155648)),
]


@pytest.mark.parametrize("shape,want", CP_PLANS)
def test_cp_plan_at_the_instance_boundaries(shape, want):
    dtype, tq, tk, dh = shape
    plan = tatt.cp_plan(tq, tk, dh, dtype)
    assert (plan["form"], plan["tiles"], plan["warps"], plan["smem"]) == want
    assert plan["tiles"] * plan["warps"] * 16 >= tq


@pytest.mark.parametrize("dtype,tq,tk,dh,limit", [
    (torch.bfloat16, 16, 64, 40, "multiple of 16 from 16 to 128"),
    (torch.float32, 16, 64, 144, "multiple of 16 from 16 to 128"),
])
def test_cp_plan_names_the_limit(dtype, tq, tk, dh, limit):
    with pytest.raises(ValueError, match=limit):
        tatt.cp_plan(tq, tk, dh, dtype)
