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
    """Meshes came with the parallelism slice; a model axis (head-sharded
    attention, JAX ``_tp_head_sharded`` :795) now runs: rank r's stream
    holds the [q | k | v] of its H / n heads (``parallel/mesh.py::
    head_major_index``), kernel 8 runs at H / n heads on it, and the
    output is the whole attention's columns of those heads, as JAX's
    ``_local_heads_attention`` gives them; heads that do not divide keep
    the whole stream."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from vit_spoof_detection_pda_tpu_torch.parallel.mesh import (
        head_major_index, make_mesh)

    x = torch.tensor(_qkv(12, 2, 17, 64))
    whole = tatt.fused_attention_qkv_plain(x, 4)
    hm, dh = jatt._head_major_relayout(jnp.asarray(x.numpy()), 4)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = make_mesh(data=1, model=2, device_type="cpu")
        calls = tatt._context["tp_calls"]
        for r in range(2):
            local = x[..., head_major_index(3 * 64, 2, r)]
            got = tatt.dispatch_attention_qkv(local, 4, mesh=mesh)
            assert got.shape == (2, 17, 32)
            assert torch.equal(got, whole[..., r * 32:(r + 1) * 32])
            want = jatt._local_heads_attention(hm[:, :, 2 * r:2 * r + 2], 2,
                                               dh, True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-6, rtol=1e-5)
        assert tatt._context["tp_calls"] == calls + 2
        x3 = torch.tensor(_qkv(13, 2, 17, 48))
        assert torch.equal(tatt.dispatch_attention_qkv(x3, 3, mesh=mesh),
                           tatt.fused_attention_qkv_plain(x3, 3))
    finally:
        dist.destroy_process_group()


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
    """The plan's shared-memory figures follow csrc/attention_self.cuh: at
    ViT-B (T 197, head dim 64) the blocks' attention stage is kernel 12's
    one pass in both dtypes (bf16: 7 warps of 16 rows and 208 keys of K
    and V, [rows][dh + 8]); T 400 at f32 is past the one pass and the
    whole f32 core, and takes its key tiles within the limit."""
    limit = tatt._MAX_SMEM
    assert tatt.module_attention_plan(197, 64, torch.bfloat16) == {
        "form": "one_pass", "tiles": 2, "warps": 7, "keys": 208,
        "smem": (7 * 16 + 2 * 208) * 72 * 2}
    f32 = tatt.module_attention_plan(197, 64, torch.float32)
    assert (f32["form"], f32["keys"]) == ("one_pass", 200)
    assert f32["smem"] <= limit
    assert 4 * (2 * 400 * 68 + 8 * 4 * (64 + 400)) > limit
    big = tatt.module_attention_plan(400, 64, torch.float32)
    assert big["form"] == "key_tiled" and big["smem"] <= limit
