"""The port's generic q/k/v attention (kernel 9's plain version,
``ops/attention.py::fused_attention_plain``, behind ``fused_attention``
and ``models/vit.py::dot_product_attention``) against the JAX package's
``fused_attention`` in interpret mode, on numpy-seeded q, k and v.

Tolerances:
- f32: 2e-6 absolute (the outputs are of magnitude up to about 3; the two
  sides take the same f32 products and softmax and sum in other orders);
- bf16: one bf16 ulp of the output's largest magnitude (the same rounding
  points; an f32 sum-order difference can flip one rounding);
- gradients at f32 against ``jax.grad`` through the JAX custom VJP: 1e-5
  absolute (the same dense recompute in another f32 order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.ops import attention as jatt
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
F32_ATOL = 2e-6
GRAD_ATOL = 1e-5


def _qkv(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _ulp(want) -> float:
    amax = float(np.abs(want).max())
    return 2.0 ** (math.floor(math.log2(amax)) - 7)


@pytest.mark.parametrize("t", [197, 33, 5])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_plain_matches_jax_interpret(t, jdt, tdt):
    q, k, v = _qkv(t, 2, t, 4, 16)
    want = np.asarray(jatt.fused_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), True).astype(jnp.float32))
    got = tatt.fused_attention(*(torch.from_numpy(x).to(tdt)
                                 for x in (q, k, v)))
    assert got.dtype == tdt and got.shape == (2, t, 4, 16)
    got = got.float().numpy()
    tol = F32_ATOL if tdt == torch.float32 else _ulp(want)
    assert np.abs(got - want).max() <= tol


def test_strided_views_equal_contiguous():
    """The int8 path passes the three slices of one [B, T, 3, H, Dh]
    projection; the result is the contiguous inputs' bit for bit."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 9, 3, 2, 16)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = x.unbind(2)
    assert not q.is_contiguous()
    got = tatt.fused_attention(q, k, v)
    want = tatt.fused_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    assert torch.equal(got, want)


def test_gradients_match_jax_grad():
    q, k, v = _qkv(3, 1, 33, 2, 16)

    def loss(q, k, v):
        return jnp.sum(jatt.fused_attention(q, k, v, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tatt.fused_attention(tq, tk, tv) ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_dot_product_attention_dense_matches_jax(jdt, tdt):
    """``use_fused=None`` on the CPU is the dense path, equal to JAX's
    dense path on the CPU (which is what ``use_fused=None`` takes off a
    TPU) within the tolerances above."""
    q, k, v = _qkv(11, 2, 17, 2, 16)
    want = np.asarray(jvit.dot_product_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), dtype=jdt
    ).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = tvit.dot_product_attention(tq, tk, tv, dtype=tdt)
    dense = tvit.dot_product_attention(tq, tk, tv, dtype=tdt,
                                       use_fused=False)
    assert torch.equal(got, dense)
    tol = F32_ATOL if tdt == torch.float32 else _ulp(want)
    assert np.abs(got.float().numpy() - want).max() <= tol
    fused = tvit.dot_product_attention(tq, tk, tv, dtype=tdt,
                                       use_fused=True)
    assert np.abs(fused.float().numpy() - want).max() <= tol


def test_plain_versions_count_no_launch():
    before = dict(tatt.LAUNCHES)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 5, 2, 16))
    tatt.fused_attention(q, k, v)
    assert tatt.LAUNCHES == before


def test_kernel_refuses_what_it_cannot_take():
    """The CUDA wrapper's checks run before any launch, so they hold on
    the CPU too: head dims outside 16..128 in steps of 16, mixed dtypes
    and shapes."""
    z = torch.zeros((1, 5, 2, 24))
    with pytest.raises(ValueError, match="head dim"):
        tatt._attention_kernel(z, z, z)
    a = torch.zeros((1, 5, 2, 16))
    with pytest.raises(TypeError, match="share one dtype"):
        tatt._attention_kernel(a, a.to(torch.bfloat16), a)
    with pytest.raises(ValueError, match="share one shape"):
        tatt._attention_kernel(a, torch.zeros((1, 6, 2, 16)), a)
    with pytest.raises(ValueError, match="no kernel for device"):
        tatt._Attention.apply(*(x.to("meta") for x in (a, a, a)))
