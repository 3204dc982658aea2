"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card and skips elsewhere.

This file imports nothing of JAX, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerance: 2 bf16 ulps of the largest output magnitude.  Both sides round
the same intermediates to bf16 but sum in different f32 orders, so a
rounding of qkv, the softmax weights or the GELU output can land one ulp
apart and move the output by about one ulp.
"""

import math

import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt

_MATS = ("x", "w_qkv", "w_proj", "w_fc1", "w_fc2")


def _inputs(seed, device, **shapes):
    """bf16 matrices and f32 vectors from a numpy seed; matrices scaled by
    their fan-in, LN scales near 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name == "ln_scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.startswith("w_"):
            v = rng.standard_normal(shape) * shape[0] ** -0.5
        elif name == "x":
            v = rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[name] = torch.tensor(
            v.astype(np.float32), device=device,
            dtype=torch.bfloat16 if name in _MATS else torch.float32)
    return out


def _attn_inputs(seed, device, b, tp, d):
    return _inputs(seed, device, x=(b, tp, d), ln_scale=(d,), ln_bias=(d,),
                   w_qkv=(d, 3 * d), b_qkv=(3 * d,), w_proj=(d, d),
                   b_proj=(d,))


def _mlp_inputs(seed, device, b, t, d, hidden):
    return _inputs(seed, device, x=(b, t, d), ln_scale=(d,), ln_bias=(d,),
                   w_fc1=(d, hidden), b_fc1=(hidden,), w_fc2=(hidden, d),
                   b_fc2=(d,))


def _assert_close(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    amax = want.abs().max().item()
    tol = 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)
    assert (got - want).abs().max().item() <= tol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,heads", [
    (2, 33, 64, 4),          # Tp = 40, ragged key and query tiles
    (3, 197, 128, 2),        # odd B, head dim 64
    (1, 197, 768, 12),       # ViT-B/16
])
def test_attention_kernel_matches_plain_on_card(cuda_device, b, t, d, heads):
    tp = tatt._round_up(t, 8)
    a = _attn_inputs(5, cuda_device, b, tp, d)
    x = a.pop("x")
    n0 = tatt.LAUNCHES["attention_block"]
    got = tatt.fused_attention_block_padded(x, *a.values(), heads,
                                            valid_len=t)
    want = tatt.fused_attention_block_padded_plain(x, *a.values(), heads,
                                                   valid_len=t)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["attention_block"] == n0 + 1
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,hidden", [
    (2, 40, 64, 256),
    (3, 197, 64, 256),       # rows not a multiple of the 128-row tile
    (2, 33, 40, 72),         # widths not multiples of the 64/128 tiles
    (1, 200, 768, 3072),     # ViT-B/16
])
def test_mlp_kernel_matches_plain_on_card(cuda_device, b, t, d, hidden):
    m = _mlp_inputs(6, cuda_device, b, t, d, hidden)
    x = m.pop("x")
    n0 = tatt.LAUNCHES["mlp_block"]
    got = tatt.fused_mlp_block(x, *m.values())
    want = tatt.fused_mlp_block_plain(x, *m.values())
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["mlp_block"] == n0 + 1
    _assert_close(got, want)


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take(cuda_device):
    a = _attn_inputs(7, cuda_device, 1, 40, 48)
    x = a.pop("x")
    with pytest.raises(ValueError, match="head dim"):   # 48 / 4 = 12
        tatt.fused_attention_block_padded(x, *a.values(), 4, valid_len=33)
    a = _attn_inputs(7, cuda_device, 1, 40, 64)
    x = a.pop("x").float()
    with pytest.raises(TypeError, match="bfloat16"):
        tatt.fused_attention_block_padded(x, *a.values(), 4, valid_len=33)
    m = _mlp_inputs(8, cuda_device, 1, 8, 44, 96)
    x = m.pop("x")
    with pytest.raises(ValueError, match="multiples of 8"):
        tatt.fused_mlp_block(x, *m.values())
