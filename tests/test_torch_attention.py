"""The port's attention-block and MLP-block wrappers against the JAX
package's Pallas kernels (interpret mode), on the same numpy-seeded
inputs.

On the CPU the port's wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against those plain versions on the
card by tests/test_torch_kernels_cuda.py (and by chip_smoke.py).

Tolerances: f32 at atol 2e-4 / rtol 1e-4, the bound of
tests/test_fastserve.py.  bf16 at 2 bf16 ulps of the largest output
magnitude: both sides round the same intermediates to bf16, but they sum
in different f32 orders, so a rounding of qkv, the softmax weights or
the GELU output can land one ulp apart and move the output by about one
ulp.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.ops import attention as jatt
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_tol(want):
    amax = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= _bf16_tol(want)


def _attn_inputs(seed, b, tp, d):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(  # noqa: E731
        np.float32)
    return dict(x=f(b, tp, d), ln_scale=1.0 + f(d, std=0.1),
                ln_bias=f(d, std=0.1), w_qkv=f(d, 3 * d, std=d ** -0.5),
                b_qkv=f(3 * d, std=0.05), w_proj=f(d, d, std=d ** -0.5),
                b_proj=f(d, std=0.05))


def _mlp_inputs(seed, b, t, d, hidden):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(  # noqa: E731
        np.float32)
    return dict(x=f(b, t, d), ln_scale=1.0 + f(d, std=0.1),
                ln_bias=f(d, std=0.1), w_fc1=f(d, hidden, std=d ** -0.5),
                b_fc1=f(hidden, std=0.05),
                w_fc2=f(hidden, d, std=hidden ** -0.5),
                b_fc2=f(d, std=0.05))


_MATS = ("x", "xp", "w_qkv", "w_proj", "w_fc1", "w_fc2")


def _jax_args(inp, jdt):
    return {k: jnp.asarray(v, jdt if k in _MATS else jnp.float32)
            for k, v in inp.items()}


def _torch_args(inp, tdt, device="cpu"):
    return {k: torch.tensor(v, dtype=tdt if k in _MATS else torch.float32,
                            device=device)
            for k, v in inp.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,heads", [
    (2, 33, 64, 4),          # Tp = 40, the ragged serving case
    (3, 33, 64, 4),          # odd B (the TPU's block_b = 1 branch)
    (2, 197, 64, 2),         # the ViT's 197 -> 200 stream, head dim 32
])
def test_attention_block_padded_matches_jax(dtype, b, t, d, heads):
    jdt, tdt = DTYPES[dtype]
    tp = tatt._round_up(t, 8)
    inp = _attn_inputs(0, b, tp, d)
    inp["x"][:, t:] = 0.0                      # the stream's zero pad rows
    ja = _jax_args(inp, jdt)
    want = jatt.fused_attention_block_padded(
        ja.pop("x"), *ja.values(), heads, valid_len=t, interpret=True)
    ta = _torch_args(inp, tdt)
    got = tatt.fused_attention_block_padded(
        ta.pop("x"), *ta.values(), heads, valid_len=t)
    assert got.dtype == tdt and got.shape == (b, tp, d)
    # pad rows included: they are computed as real rows on both sides
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_block_unpadded_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    inp = _attn_inputs(1, 2, 33, 64)
    ja = _jax_args(inp, jdt)
    want = jatt.fused_attention_block(ja.pop("x"), *ja.values(), 4,
                                      interpret=True)
    ta = _torch_args(inp, tdt)
    got = tatt.fused_attention_block(ta.pop("x"), *ta.values(), 4)
    assert got.shape == (2, 33, 64)
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t", [
    (2, 40),                 # 80 rows: one partial 256-row TPU tile
    (3, 200),                # 600 rows: three TPU tiles, the last partial
])
def test_mlp_block_matches_jax(dtype, b, t):
    jdt, tdt = DTYPES[dtype]
    inp = _mlp_inputs(2, b, t, 64, 256)
    ja = _jax_args(inp, jdt)
    want = jatt.fused_mlp_block(ja.pop("x"), *ja.values(), interpret=True)
    ta = _torch_args(inp, tdt)
    got = tatt.fused_mlp_block(ta.pop("x"), *ta.values())
    assert got.dtype == tdt and got.shape == (b, t, 64)
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version and counts no kernel launch."""
    before = dict(tatt.LAUNCHES)
    a = _torch_args(_attn_inputs(3, 1, 8, 32), torch.bfloat16)
    m = _torch_args(_mlp_inputs(3, 1, 8, 32, 64), torch.bfloat16)
    x = a.pop("x")
    out = tatt.fused_attention_block_padded(x, *a.values(), 2, valid_len=5)
    want = tatt.fused_attention_block_padded_plain(x, *a.values(), 2,
                                                   valid_len=5)
    assert torch.equal(out, want)
    x = m.pop("x")
    assert torch.equal(tatt.fused_mlp_block(x, *m.values()),
                       tatt.fused_mlp_block_plain(x, *m.values()))
    assert tatt.LAUNCHES == before


def test_head_geometry_is_checked():
    assert tatt._check_head_geometry(192, 4, fused=3) == 64
    with pytest.raises(ValueError, match="not divisible by 3"):
        tatt._check_head_geometry(100, 4, fused=3)
    with pytest.raises(ValueError, match="num_heads"):
        tatt._check_head_geometry(64, 3)


def test_plain_versions_leave_tf32_flags_as_found():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    a = _torch_args(_attn_inputs(4, 1, 8, 32), torch.float32)
    x = a.pop("x")
    tatt.fused_attention_block_padded_plain(x, *a.values(), 2, valid_len=8)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == prev
