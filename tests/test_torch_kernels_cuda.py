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
from vit_spoof_detection_pda_tpu_torch.ops import ln_bwd as tln
from vit_spoof_detection_pda_tpu_torch.ops import lowlat as tlow

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


# --------------------------------------------------------------------------
# training kernels
# --------------------------------------------------------------------------

# (B, Tp, valid_len, D, heads): ViT-B at B = 2, 3 and the main path's 128,
# and a ragged shape (Tp 40, head dim 16)
TRAIN_CASES = [(2, 200, 197, 768, 12), (3, 200, 197, 768, 12),
               (128, 200, 197, 768, 12), (2, 40, 33, 64, 4)]


def _bf16(rng, *shape, std=1.0, device):
    v = rng.standard_normal(shape).astype(np.float32) * np.float32(std)
    return torch.tensor(v, device=device).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads", TRAIN_CASES)
def test_attention_block_train_kernel_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads):
    a = _attn_inputs(11, cuda_device, b, tp, d)
    x = a.pop("x")
    n0 = tatt.LAUNCHES["attention_block_train"]
    got = tatt.attention_block_train_padded(x, *a.values(), heads,
                                            valid_len=valid)
    want = tatt.attention_block_train_padded_plain(x, *a.values(), heads,
                                                   valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["attention_block_train"] == n0 + 1
    for gg, ww in zip(got, want):          # out, qkv, attn, xhat, inv
        assert gg.dtype == ww.dtype
        _assert_close(gg, ww)


def _qkv_bwd_inputs(seed, device, b, tp, valid, d):
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng, b, tp, 3 * d, device=device)
    g = _bf16(rng, b, tp, d, device=device)
    g[:, valid:] = 0                        # pad rows carry no cotangent
    return qkv, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads", TRAIN_CASES)
def test_attention_qkv_bwd_kernel_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads):
    qkv, g = _qkv_bwd_inputs(12, cuda_device, b, tp, valid, d)
    n0 = tatt.LAUNCHES["attention_qkv_bwd"]
    got = tatt.attention_qkv_bwd(qkv, g, heads, valid_len=valid)
    want = tatt.attention_qkv_bwd_plain(qkv, g, heads, valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["attention_qkv_bwd"] == n0 + 1
    for part in range(3):                   # dq, dk, dv
        cols = slice(part * d, (part + 1) * d)
        _assert_close(got[..., cols], want[..., cols])


def _ln_bwd_inputs(seed, device, b, tq, d, dxn_dtype):
    rng = np.random.default_rng(seed)
    xh = _bf16(rng, b, tq, d, device=device)
    inv = torch.tensor(rng.uniform(0.5, 2.0, (b, tq, 1)).astype(np.float32),
                       device=device)
    dxn = _bf16(rng, b, tq, d, device=device).to(dxn_dtype)
    g = _bf16(rng, b, tq, d, device=device)
    lns = torch.tensor((1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                       device=device)
    return xh, inv, dxn, g, lns


@pytest.mark.cuda
@pytest.mark.parametrize("dxn_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,tp,valid,d,heads", TRAIN_CASES)
def test_ln_res_bwd_kernel_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads, dxn_dtype):
    xh, inv, dxn, g, lns = _ln_bwd_inputs(13, cuda_device, b, tp, d,
                                          dxn_dtype)
    dxn[:, valid:] = 0                      # padding contract
    g[:, valid:] = 0
    n0 = tatt.LAUNCHES["ln_res_bwd"]
    got = tln.ln_residual_bwd(xh, inv, dxn, g, lns)
    again = tln.ln_residual_bwd(xh, inv, dxn, g, lns)
    want = tln.ln_residual_bwd_plain(xh, inv, dxn, g, lns)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["ln_res_bwd"] == n0 + 2
    for gg, ww in zip(got, want):           # dx, dscale, dbias
        _assert_close(gg, ww)
    assert (got[0][:, valid:] == 0).all()
    # the parameter sums are reduced in a fixed order: bit for bit
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


@pytest.mark.cuda
def test_training_kernels_reject_what_they_cannot_take(cuda_device):
    qkv, g = _qkv_bwd_inputs(14, cuda_device, 1, 40, 33, 96)
    with pytest.raises(ValueError, match="head dim"):     # 96 / 2 = 48
        tatt.attention_qkv_bwd(qkv, g, 2, valid_len=33)
    qkv, g = _qkv_bwd_inputs(14, cuda_device, 1, 256, 197, 768)
    with pytest.raises(ValueError, match="shared memory"):
        tatt.attention_qkv_bwd(qkv, g, 12, valid_len=197)
    xh, inv, dxn, g, lns = _ln_bwd_inputs(15, cuda_device, 1, 8, 44,
                                          torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        tln.ln_residual_bwd(xh, inv, dxn, g, lns)


# --------------------------------------------------------------------------
# whole-encoder (lowlat) kernels
# --------------------------------------------------------------------------

def _encoder_tree(seed, depth, d, hh=0):
    """A JAX-layout ViT tree from a numpy seed (encoder matrices
    N(0, 0.02), LN scales near 1; with ``hh`` the stem, the final LN and
    an anti-spoof head for fold-ends, patch_dim == d)."""
    rng = np.random.default_rng(seed)

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def dense(i, o, std=0.02):
        return {"kernel": n(i, o, std=std), "bias": n(o, std=0.02)}

    def ln(dim):
        return {"scale": 1.0 + n(dim, std=0.1), "bias": n(dim, std=0.05)}

    vit = {f"block{i}": {"norm1": ln(d), "attn": {
        "qkv": dense(d, 3 * d), "proj": dense(d, d)}, "norm2": ln(d),
        "mlp": {"fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}}
        for i in range(depth)}
    if not hh:
        return {"vit": vit}
    vit.update(patch_embed=dense(d, d), cls_token=n(1, 1, d, std=0.02),
               pos_embed=n(1, 197, d, std=0.02), norm=ln(d))
    head = {"norm": ln(d), "fc1": dense(d, hh, std=d ** -0.5),
            "fc2": dense(hh, 2, std=0.1)}
    return {"vit": vit, "head": head}


def _stream(seed, b, tp, d, device):
    rng = np.random.default_rng(seed)
    return _bf16(rng, b, tp, d, device=device)


# (B, Tp, valid_len, D, heads, depth): ViT-B at depth 1, and a ragged
# shape (Tp 40, head dim 16) at depth 2
LOWLAT_CASES = [(1, 200, 197, 768, 12, 1), (2, 200, 197, 768, 12, 1),
                (1, 40, 33, 64, 4, 2)]


def _assert_close_layers(got, want, depth):
    """2 bf16 ulps of the largest output magnitude per layer: the
    kernel and its plain version round at the same points, and a flip of
    one rounding moves the output by about an ulp in each layer."""
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    amax = want.abs().max().item()
    tol = 2.0 * depth * 2.0 ** (math.floor(math.log2(amax)) - 7)
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads,depth", LOWLAT_CASES)
def test_lowlat_encoder_kernel_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads, depth):
    w, s = tlow.pack_encoder_weights(_encoder_tree(20, depth, d)["vit"],
                                     depth=depth, device=cuda_device)
    x = _stream(21, b, tp, d, cuda_device)
    n0 = tatt.LAUNCHES["lowlat_encoder"]
    got = tlow.encoder_forward_lowlat(x, w, s, num_heads=heads,
                                      valid_len=valid)
    again = tlow.encoder_forward_lowlat(x, w, s, num_heads=heads,
                                        valid_len=valid)
    want = tlow.encoder_forward_lowlat_plain(x, w, s, num_heads=heads,
                                             valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["lowlat_encoder"] == n0 + 2
    _assert_close_layers(got, want, depth)
    assert torch.equal(got, again)          # back-to-back launches agree


@pytest.mark.cuda
def test_lowlat_fold_ends_kernel_matches_plain_on_card(cuda_device):
    d, tp, valid, hh = 768, 200, 197, 512
    tree = _encoder_tree(22, 1, d, hh)
    w, s = tlow.pack_encoder_weights(tree["vit"], depth=1,
                                     device=cuda_device)
    ends = tlow.pack_end_weights(tree, device=cuda_device)
    rng = np.random.default_rng(23)
    xp = torch.tensor(rng.integers(0, 256, (1, tp, d)).astype(np.float32),
                      device=cuda_device).to(torch.bfloat16)
    xp[:, 0] = 0
    xp[:, valid:] = 0
    n0 = tatt.LAUNCHES["lowlat_encoder"]
    got = tlow.forward_lowlat_e2e(xp, w, s, *ends, num_heads=12,
                                  valid_len=valid)
    want = tlow.forward_lowlat_e2e_plain(xp, w, s, *ends, num_heads=12,
                                         valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["lowlat_encoder"] == n0 + 1
    assert got.shape == (1, 2) and got.dtype == torch.float32
    _assert_close_layers(got, want, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads,depth",
                         [(c, 200, 197, 768, 12, 1) for c in (1, 2, 3, 4)]
                         + [(3, 40, 33, 64, 4, 2)])
def test_lowlat_batchgrid_kernel_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads, depth):
    w, s = tlow.pack_encoder_weights_batchgrid(
        _encoder_tree(24, depth, d)["vit"], depth=depth, device=cuda_device)
    x = _stream(25, b, tp, d, cuda_device)
    if b > 1:
        x[-1] = 0                            # a zero pad item
    n0 = tatt.LAUNCHES["lowlat_batchgrid"]
    got = tlow.encoder_forward_lowlat_batchgrid(x, w, s, num_heads=heads,
                                                valid_len=valid)
    want = tlow.encoder_forward_lowlat_batchgrid_plain(
        x, w, s, num_heads=heads, valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["lowlat_batchgrid"] == n0 + 1
    _assert_close_layers(got, want, depth)


@pytest.mark.cuda
def test_lowlat_kernels_reject_what_they_cannot_take(cuda_device):
    w, s = tlow.pack_encoder_weights(_encoder_tree(26, 1, 96)["vit"],
                                     depth=1, device=cuda_device)
    x = _stream(27, 1, 40, 96, cuda_device)
    with pytest.raises(ValueError, match="head dim"):     # 96 / 2 = 48
        tlow.encoder_forward_lowlat(x, w, s, num_heads=2, valid_len=33)
    with pytest.raises(TypeError, match="bfloat16"):
        tlow.encoder_forward_lowlat(x.float(), w, s, num_heads=3,
                                    valid_len=33)
    with pytest.raises(ValueError, match="<= 4"):
        tlow.encoder_forward_lowlat_batchgrid(
            _stream(27, 5, 40, 96, cuda_device), w, s, num_heads=3,
            valid_len=33)


@pytest.mark.cuda
def test_lowlat_trace_stamps_every_barrier(cuda_device):
    w, s = tlow.pack_encoder_weights(_encoder_tree(28, 2, 64)["vit"],
                                     depth=2, device=cuda_device)
    x = _stream(29, 2, 40, 64, cuda_device)
    kw = dict(num_heads=4, valid_len=33)
    trace = torch.zeros(tlow.trace_slots(2), dtype=torch.int64,
                        device=cuda_device)
    got = tlow.encoder_forward_lowlat(x, w, s, trace=trace, **kw)
    want = tlow.encoder_forward_lowlat(x, w, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)           # tracing changes no result
    stamps = trace.cpu()
    assert (stamps > 0).all() and (stamps.diff() >= 0).all()
    with pytest.raises(ValueError, match="stamps"):
        tlow.encoder_forward_lowlat(x, w, s, trace=trace[:-1], **kw)
