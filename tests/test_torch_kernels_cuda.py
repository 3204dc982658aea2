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


# --------------------------------------------------------------------------
# augmentation kernels: pool gather, warp pass, NLM
# --------------------------------------------------------------------------

from vit_spoof_detection_pda_tpu_torch.ops import gather as tgather  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import nlm as tnlm  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import warp as twarp  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((300, 224, 224, 3), torch.uint8),
                                         ((37, 5, 7, 3), torch.uint8),
                                         ((11, 2, 128), torch.float32)])
def test_pool_gather_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    rng = np.random.default_rng(30)
    pool = torch.tensor(rng.integers(0, 256, shape), dtype=dtype,
                        device=cuda_device)
    idx = rng.integers(0, shape[0], 128 if shape[0] > 100 else 5)
    n0 = tatt.LAUNCHES["pool_gather"]
    got = tgather.pool_gather(pool, idx)
    want = tgather.pool_gather_plain(pool, idx)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["pool_gather"] == n0 + 1
    assert torch.equal(got, want)
    with pytest.raises(IndexError):
        tgather.pool_gather(pool, np.array([shape[0]]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("along_y", [False, True])
@pytest.mark.parametrize("b,h,w,kmax,lim", [(4, 224, 224, 21, 20.9),
                                            (3, 250, 190, 9, 12.0),
                                            (2, 31, 29, 4, 3.9)])
def test_warp_pass_kernel_matches_plain_on_card(cuda_device, dtype, along_y,
                                                b, h, w, kmax, lim):
    rng = np.random.default_rng(31)
    img = torch.tensor(rng.random((b, h, w, 3), dtype=np.float32),
                       device=cuda_device).to(dtype)
    field = torch.tensor((rng.random((b, h, w)) * 2 - 1).astype(np.float32)
                         * lim, device=cuda_device)
    n0 = tatt.LAUNCHES["warp_pass"]
    got = twarp.warp_pass(img, field, kmax, along_y=along_y)
    want = twarp.warp_pass_plain(img, field, kmax, along_y=along_y)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["warp_pass"] == n0 + 1
    assert got.dtype == dtype
    assert torch.equal(got, want)
    # a broadcast field (the rotation passes' per-row shifts)
    rows = field[:, :, :1].expand(b, h, w)
    assert torch.equal(twarp.warp_pass(img, rows, kmax, along_y=along_y),
                       twarp.warp_pass_plain(img, rows.contiguous(), kmax,
                                             along_y=along_y))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,r,p", [(2, 224, 224, 3, 5, 1),
                                         (1, 250, 190, 3, 5, 1),
                                         (2, 20, 17, 1, 2, 2)])
def test_nlm_kernel_matches_plain_on_card(cuda_device, b, h, w, c, r, p):
    rng = np.random.default_rng(32)
    img = torch.tensor(rng.random((b, h, w, c), dtype=np.float32),
                       device=cuda_device)
    kw = dict(search_radius=r, patch_radius=p)
    n0 = tatt.LAUNCHES["nlm"]
    got = tnlm.nlm_denoise(img, **kw)
    want = tnlm.nlm_denoise_plain(img, **kw)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["nlm"] == n0 + 1
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_augmentation_kernels_reject_what_they_cannot_take(cuda_device):
    img = torch.zeros(1, 8, 8, 5, device=cuda_device)
    with pytest.raises(ValueError, match="1-4 channels"):
        twarp.warp_pass(img, torch.zeros(1, 8, 8, device=cuda_device), 2)
    with pytest.raises(TypeError, match="float32"):
        tnlm.nlm_denoise(img[..., :3].half())
    with pytest.raises(ValueError, match="host indices"):
        tgather.pool_gather(img, torch.zeros(1, dtype=torch.long,
                                             device=cuda_device))


# --------------------------------------------------------------------------
# kernel 8: attention core on the fused projection (the module path)
# --------------------------------------------------------------------------


def _assert_close_f32(got, want):
    """f32: within 1e-5 of the largest output magnitude (the same f32
    products and softmax, summed in other orders)."""
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,d,heads", [
    (2, 197, 768, 12), (3, 197, 768, 12), (2, 33, 64, 4), (1, 5, 128, 2)])
def test_attention_qkv_kernel_matches_plain_on_card(cuda_device, dtype, b, t,
                                                    d, heads):
    rng = np.random.default_rng(b * t)
    qkv = torch.tensor(rng.standard_normal((b, t, 3 * d)).astype(np.float32),
                       device=cuda_device).to(dtype)
    before = tatt.LAUNCHES["attention_qkv"]
    got = tatt.fused_attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["attention_qkv"] == before + 1
    assert got.dtype == dtype
    want = tatt.fused_attention_qkv_plain(qkv, heads)
    if dtype == torch.bfloat16:
        _assert_close(got, want)
    else:
        _assert_close_f32(got, want)


@pytest.mark.cuda
def test_attention_qkv_backward_on_card(cuda_device):
    """bf16: kernel 4 behind the autograd function, within 2 bf16 ulps of
    its plain version; f32: kernel 4's f32 form on the unpadded T = 197
    stream, within f32 noise of its plain version."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 197, 3 * 768)).astype(np.float32)
    g = torch.tensor(rng.standard_normal((2, 197, 768)).astype(np.float32),
                     device=cuda_device).bfloat16()
    qkv = torch.tensor(x, device=cuda_device).bfloat16().requires_grad_()
    tatt.fused_attention_qkv(qkv, 12).backward(g)
    _assert_close(qkv.grad, tatt.attention_qkv_bwd_plain(
        qkv.detach(), g, 12, valid_len=197))
    q32 = torch.tensor(x, device=cuda_device, requires_grad=True)
    n0 = tatt.LAUNCHES["attention_qkv_bwd_f32"]
    tatt.fused_attention_qkv(q32, 12).backward(g.float())
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["attention_qkv_bwd_f32"] == n0 + 1
    want = tatt.attention_qkv_bwd_plain(q32.detach(), g.float(), 12,
                                        valid_len=197)
    for part in range(3):
        cols = slice(part * 768, (part + 1) * 768)
        _assert_close_f32(q32.grad[..., cols], want[..., cols])


@pytest.mark.cuda
def test_attention_qkv_kernel_rejects_what_it_cannot_take(cuda_device):
    qkv = torch.zeros((2, 197, 3 * 768), device=cuda_device,
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tatt.fused_attention_qkv(torch.zeros((2, 9, 3 * 72),
                                             device=cuda_device), 3)  # dh 24
    with pytest.raises(ValueError, match="head dim"):
        tatt.fused_attention_qkv(qkv, 3)                              # dh 256
    with pytest.raises(TypeError):
        tatt.fused_attention_qkv(qkv.half(), 12)
    with pytest.raises(ValueError, match="shared memory"):
        tatt.fused_attention_qkv(torch.zeros((1, 400, 3 * 64),
                                             device=cuda_device), 1)


# --------------------------------------------------------------------------
# the f32 forms of the training kernels, and kernel 7 (the training MLP)
# --------------------------------------------------------------------------

# ViT-B at B = 2, 3 and the f32 step's 32, and the ragged shape
F32_CASES = [(2, 200, 197, 768, 12), (3, 200, 197, 768, 12),
             (32, 200, 197, 768, 12), (2, 40, 33, 64, 4)]


def _f32(tensors):
    return [t.float() if t.dtype == torch.bfloat16 else t for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads", F32_CASES)
def test_attention_block_f32_kernels_match_plain_on_card(
        cuda_device, b, tp, valid, d, heads):
    """Kernels 1 and 3 at f32 (one library, with and without the
    residual outputs): within 1e-5 of each output's largest magnitude,
    f32 sum-order noise."""
    a = _attn_inputs(21, cuda_device, b, tp, d)
    x, *w = _f32(a.values())
    n0 = dict(tatt.LAUNCHES)
    got = tatt.attention_block_train_padded(x, *w, heads, valid_len=valid)
    out = tatt.fused_attention_block_padded(x, *w, heads, valid_len=valid)
    want = tatt.attention_block_train_padded_plain(x, *w, heads,
                                                   valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["attention_block_train_f32"] == (
        n0["attention_block_train_f32"] + 1)
    assert tatt.LAUNCHES["attention_block_f32"] == (
        n0["attention_block_f32"] + 1)
    for gg, ww in zip(got, want):          # out, qkv, attn, xhat, inv
        assert gg.dtype == ww.dtype == torch.float32
        _assert_close_f32(gg, ww)
    assert torch.equal(out, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads", F32_CASES)
def test_attention_qkv_bwd_f32_kernel_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads):
    qkv, g = _f32(_qkv_bwd_inputs(22, cuda_device, b, tp, valid, d))
    n0 = tatt.LAUNCHES["attention_qkv_bwd_f32"]
    got = tatt.attention_qkv_bwd(qkv, g, heads, valid_len=valid)
    want = tatt.attention_qkv_bwd_plain(qkv, g, heads, valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["attention_qkv_bwd_f32"] == n0 + 1
    for part in range(3):                   # dq, dk, dv
        cols = slice(part * d, (part + 1) * d)
        _assert_close_f32(got[..., cols], want[..., cols])
    assert (got[:, :, 2 * d:][:, valid:] == 0).all()   # masked keys: dv 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads", F32_CASES)
def test_ln_res_bwd_f32_kernel_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads):
    xh, inv, dxn, g, lns = _ln_bwd_inputs(23, cuda_device, b, tp, d,
                                          torch.float32)
    xh, g = xh.float(), g.float()
    dxn[:, valid:] = 0
    g[:, valid:] = 0
    n0 = tatt.LAUNCHES["ln_res_bwd_f32"]
    got = tln.ln_residual_bwd(xh, inv, dxn, g, lns)
    again = tln.ln_residual_bwd(xh, inv, dxn, g, lns)
    want = tln.ln_residual_bwd_plain(xh, inv, dxn, g, lns)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["ln_res_bwd_f32"] == n0 + 2
    assert got[0].dtype == torch.float32
    for gg, ww in zip(got, want):           # dx, dscale, dbias
        _assert_close_f32(gg, ww)
    assert (got[0][:, valid:] == 0).all()
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("rows,d,hidden", [
    (2 * 197, 768, 3072),    # ViT-B/16
    (3 * 33, 64, 256),       # rows not a multiple of the 128-row tile
    (2 * 33, 40, 72),        # widths not multiples of the tiles
])
def test_mlp_block_train_kernel_matches_plain_on_card(
        cuda_device, dtype, approximate, rows, d, hidden):
    """Kernel 7: bf16 within 2 bf16 ulps of each output's largest
    magnitude, f32 within 1e-5 of it."""
    m = _mlp_inputs(24, cuda_device, 1, rows, d, hidden)
    x, *w = m.values()
    x = x[0]
    if dtype == torch.float32:
        x, *w = _f32([x, *w])
    name = "mlp_block_train" + ("_f32" if dtype == torch.float32 else "")
    n0 = tatt.LAUNCHES[name]
    got = tatt.mlp_block_train(x, *w, approximate=approximate)
    want = tatt.mlp_block_train_plain(x, *w, approximate=approximate)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES[name] == n0 + 1
    for gg, ww in zip(got, want):           # y, xhat, inv, h
        assert gg.dtype == ww.dtype and gg.shape == ww.shape
        if gg.dtype == torch.bfloat16:
            _assert_close(gg, ww)
        else:
            _assert_close_f32(gg, ww)


@pytest.mark.cuda
def test_f32_kernels_reject_what_they_cannot_take(cuda_device):
    qkv, g = _f32(_qkv_bwd_inputs(25, cuda_device, 1, 400, 197, 768))
    with pytest.raises(ValueError, match="shared memory"):
        tatt.attention_qkv_bwd(qkv, g, 12, valid_len=197)
    xh, inv, dxn, g, lns = _ln_bwd_inputs(26, cuda_device, 1, 8, 64,
                                          torch.bfloat16)
    with pytest.raises(TypeError, match="f32"):      # f32 xh, bf16 dxn
        tln.ln_residual_bwd(xh.float(), inv, dxn, g.float(), lns)
    m = _mlp_inputs(27, cuda_device, 1, 8, 64, 256)
    x, *w = m.values()
    with pytest.raises(TypeError):                   # f32 x, bf16 weights
        tatt.mlp_block_train(x[0].float(), *w, approximate=False)


# --------------------------------------------------------------------------
# The phased attention backward (kernel 5) and the doctor's probe (17)
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,tp,valid,d,heads", [
    (torch.bfloat16, 2, 40, 33, 64, 4),      # ragged, head dim 16
    (torch.bfloat16, 3, 200, 197, 768, 12),  # ViT-B/16, odd B
    (torch.bfloat16, 17, 200, 197, 768, 12),  # two chunks of the workspace
    (torch.float32, 2, 40, 33, 64, 4),
    (torch.float32, 2, 200, 197, 768, 12),
])
def test_attention_qkv_bwd_phased_kernel_matches_plain_on_card(
        cuda_device, dtype, b, tp, valid, d, heads):
    rng = np.random.default_rng(40)
    qkv = torch.tensor(rng.standard_normal((b, tp, 3 * d)).astype(np.float32),
                       device=cuda_device, dtype=dtype)
    g = torch.tensor(rng.standard_normal((b, tp, d)).astype(np.float32),
                     device=cuda_device, dtype=dtype)
    g[:, valid:] = 0
    name = "attention_qkv_bwd_phased" + (
        "_f32" if dtype == torch.float32 else "")
    n0 = tatt.LAUNCHES[name]
    got = tatt.attention_qkv_bwd_phased(qkv, g, heads, valid_len=valid)
    want = tatt.attention_qkv_bwd_plain(qkv, g, heads, valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES[name] == n0 + 1
    assert (got[:, valid:] == 0).all()
    for i in range(3):
        part_got, part_want = got[..., i * d:(i + 1) * d], want[
            ..., i * d:(i + 1) * d]
        if dtype == torch.bfloat16:
            _assert_close(part_got, part_want)
        else:
            err = (part_got - part_want).abs().max().item()
            assert err <= 1e-5 * part_want.abs().max().item()


@pytest.mark.cuda
def test_bwd_phased_flag_selects_kernel_5(cuda_device, monkeypatch):
    rng = np.random.default_rng(41)
    qkv = torch.tensor(rng.standard_normal((2, 40, 192)).astype(np.float32),
                       device=cuda_device, dtype=torch.bfloat16)
    g = torch.tensor(rng.standard_normal((2, 40, 64)).astype(np.float32),
                     device=cuda_device, dtype=torch.bfloat16)
    monkeypatch.setattr(tatt, "BWD_PHASED", True)
    n4, n5 = (tatt.LAUNCHES["attention_qkv_bwd"],
              tatt.LAUNCHES["attention_qkv_bwd_phased"])
    tatt.attention_qkv_bwd(qkv, g, 4, valid_len=40)
    assert tatt.LAUNCHES["attention_qkv_bwd"] == n4
    assert tatt.LAUNCHES["attention_qkv_bwd_phased"] == n5 + 1


@pytest.mark.cuda
def test_doctor_probe_kernel_on_card(cuda_device):
    from vit_spoof_detection_pda_tpu_torch.ops import probe

    n0 = probe.LAUNCHES["doctor_probe"]
    x = torch.ones((8, 128), device=cuda_device)
    out = probe.doctor_probe(x)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["doctor_probe"] == n0 + 1
    assert out.sum().item() == 2048.0
    assert torch.equal(out, probe.doctor_probe_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,heads,dh,strided", [
    (torch.bfloat16, 2, 33, 4, 16, False),   # ragged query and key tiles
    (torch.bfloat16, 3, 197, 12, 64, True),  # the int8 path's views
    (torch.float32, 2, 197, 12, 64, True),
    (torch.float32, 2, 33, 4, 16, False),
])
def test_attention_kernel_matches_plain_on_card(cuda_device, dtype, b, t,
                                                heads, dh, strided):
    """Kernel 9 (q/k/v attention): bf16 within 2 ulps, f32 within 1e-5
    of the largest output magnitude; strided q/k/v are the three slices
    of one [B, T, 3, H, Dh] projection."""
    rng = np.random.default_rng(50)
    x = torch.tensor(rng.standard_normal((b, t, 3, heads, dh)).astype(
        np.float32), device=cuda_device, dtype=dtype)
    q, k, v = x.unbind(2)
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    name = "attention" if dtype == torch.bfloat16 else "attention_f32"
    n0 = tatt.LAUNCHES[name]
    got = tatt.fused_attention(q, k, v)
    want = tatt.fused_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES[name] == n0 + 1
    if dtype == torch.bfloat16:
        _assert_close(got, want)
    else:
        assert ((got - want).abs().max().item()
                <= 1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
def test_lowlat_encoder_int8_matches_plain_on_card(cuda_device, b):
    """Kernel 10 on the int8 pack (the _wblk dequant in the weight
    stage), one ragged layer: within 2 bf16 ulps of the plain version."""
    rng = np.random.default_rng(51)
    d, hidden = 64, 256

    def dense(i, o):
        return {"kernel": (rng.standard_normal((i, o)) * i ** -0.5).astype(
            np.float32), "bias": (0.1 * rng.standard_normal(o)).astype(
            np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(
            np.float32), "bias": (0.1 * rng.standard_normal(d)).astype(
            np.float32)}

    vit = {"block0": {"norm1": ln(), "norm2": ln(),
                      "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
                      "mlp": {"fc1": dense(d, hidden),
                              "fc2": dense(hidden, d)}}}
    w, s = tlow.pack_encoder_weights(vit, depth=1, device=cuda_device,
                                     weight_dtype=torch.int8)
    x = torch.tensor(rng.standard_normal((b, 40, d)).astype(np.float32),
                     device=cuda_device, dtype=torch.bfloat16)
    n0 = tlow.LAUNCHES["lowlat_encoder_int8"]
    got = tlow.encoder_forward_lowlat(x, w, s, num_heads=4, valid_len=33)
    want = tlow.encoder_forward_lowlat_plain(x, w, s, num_heads=4,
                                             valid_len=33)
    torch.cuda.synchronize()
    assert tlow.LAUNCHES["lowlat_encoder_int8"] == n0 + 1
    _assert_close(got, want)
