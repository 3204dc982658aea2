"""Kernel 8's plain version and its autograd against the JAX package's
``fused_attention_qkv`` (the Pallas kernel in interpret mode) on the same
numpy-seeded ``qkv``, and the port's dispatch.

On the CPU ``fused_attention_qkv`` runs its plain version; the CUDA
kernel is held against that plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances: f32 at atol 2e-6 / rtol 1e-5 (the same f32 products and
softmax, summed in another order); bf16 at 2 bf16 ulps of the largest
output magnitude (the weights round to bf16 on both sides, and a
rounding that lands one ulp apart moves the output by about one ulp).
The backward at f32 against ``jax.vjp`` at atol 1e-5 / rtol 1e-4.
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
SHAPES = [(2, 17, 64, 4), (3, 33, 64, 4), (2, 197, 64, 4),
          (2, 17, 768, 12), (3, 197, 768, 12)]


def _qkv(seed, b, t, d):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, 3 * d)).astype(np.float32)


def _bf16_tol(want):
    amax = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", SHAPES)
def test_plain_matches_jax_kernel(dtype, b, t, d, heads):
    jdt, tdt = DTYPES[dtype]
    x = _qkv(b * 1000 + t, b, t, d)
    want = np.asarray(jatt.fused_attention_qkv(jnp.asarray(x, jdt), heads,
                                               True), np.float32)
    got = tatt.fused_attention_qkv(torch.tensor(x).to(tdt), heads)
    assert got.dtype == tdt and tuple(got.shape) == (b, t, d)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= _bf16_tol(want)


@pytest.mark.parametrize("b,t,d,heads", [(2, 17, 64, 4), (3, 33, 64, 4)])
def test_backward_matches_jax_vjp_f32(b, t, d, heads):
    x = _qkv(7 + t, b, t, d)
    g = np.random.default_rng(8 + t).standard_normal(
        (b, t, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q: jatt.fused_attention_qkv(q, heads, True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.tensor(x, requires_grad=True)
    tatt.fused_attention_qkv(xt, heads).backward(torch.tensor(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=1e-4)


def test_backward_matches_plain_autograd():
    """The autograd function's backward (kernel 4's plain version) equals
    autograd through the plain forward's own ops at f32."""
    x = _qkv(9, 2, 33, 64)
    g = torch.tensor(np.random.default_rng(10).standard_normal(
        (2, 33, 64)).astype(np.float32))
    a = torch.tensor(x, requires_grad=True)
    tatt.fused_attention_qkv(a, 4).backward(g)
    b = torch.tensor(x, requires_grad=True)
    tatt.fused_attention_qkv_plain(b, 4).backward(g)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6,
                               rtol=1e-5)


def test_dispatch_cpu_takes_the_plain_version_and_counts_no_launch():
    x = torch.tensor(_qkv(11, 2, 17, 64))
    before = dict(tatt.LAUNCHES)
    got = tatt.dispatch_attention_qkv(x, 4)
    assert tatt.LAUNCHES == before
    assert torch.equal(got, tatt.fused_attention_qkv_plain(x, 4))


def test_dispatch_with_a_mesh_raises_naming_slice_6():
    x = torch.tensor(_qkv(12, 2, 17, 64))
    with pytest.raises(NotImplementedError, match="slice 6"):
        tatt.dispatch_attention_qkv(x, 4, mesh=object())


def test_non_contiguous_input_is_taken_as_its_values():
    x = torch.tensor(_qkv(13, 2, 17, 64))
    view = torch.cat([x, x], dim=-1)[..., :192]
    assert not view.is_contiguous()
    assert torch.equal(tatt.fused_attention_qkv(view, 4),
                       tatt.fused_attention_qkv_plain(x, 4))


def test_indivisible_geometry_raises():
    with pytest.raises(ValueError, match="not divisible"):
        tatt.fused_attention_qkv(torch.zeros(1, 5, 3 * 64), 5)


def test_kernel_shared_memory_bound_matches_the_source():
    """The wrapper's shared-memory estimate follows csrc/attention_qkv.cu:
    ViT-B (T 197, head dim 64) fits in both dtypes; T 400 at f32 does
    not."""
    limit = tatt._MAX_SMEM
    assert tatt._attention_qkv_smem(197, 64, torch.bfloat16) == 2 * 208 * 72 * 2
    assert tatt._attention_qkv_smem(197, 64, torch.float32) == 4 * (
        2 * 197 * 68 + 8 * 4 * (64 + 197))
    assert tatt._attention_qkv_smem(197, 64, torch.float32) <= limit
    assert tatt._attention_qkv_smem(400, 64, torch.float32) > limit
