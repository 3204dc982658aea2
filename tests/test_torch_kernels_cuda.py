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
from vit_spoof_detection_pda_tpu_torch.ops import gemm as tgemm
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
    """What no route of the attention backward takes: a head dim that is
    not a multiple of 16, a valid_len past Tp (head dim 48 and Tp 256,
    which kernel 4 refused, now run the key-tiled backward:
    test_attention_qkv_bwd_routes_past_kernel_4_on_card)."""
    qkv, g = _qkv_bwd_inputs(14, cuda_device, 1, 40, 33, 96)
    with pytest.raises(ValueError, match="head dim"):     # 96 / 4 = 24
        tatt.attention_qkv_bwd(qkv, g, 4, valid_len=33)
    qkv, g = _qkv_bwd_inputs(14, cuda_device, 1, 256, 197, 768)
    with pytest.raises(ValueError, match="valid_len"):
        tatt.attention_qkv_bwd(qkv, g, 12, valid_len=257)
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


# The launch plan of both whole-encoder kernels, across what the wrappers
# take: (kernel, B, Tp, D, heads, hh, int8)
LOWLAT_PLAN_SHAPES = [
    (k, b, tp, d, heads, 512 if k == "lowlat_e2e" else 0, int8)
    for k, int8s in (("lowlat_encoder", (False, True)),
                     ("lowlat_e2e", (False, True)),
                     ("lowlat_batchgrid", (False,)))
    for int8 in int8s for b in (1, 2, 3, 4)
    for tp, d, heads in ((8, 64, 4), (40, 96, 3), (64, 768, 12),
                         (200, 768, 12), (208, 768, 48), (584, 768, 12))
    if k != "lowlat_e2e" or d == 768]


@pytest.mark.cuda
def test_lowlat_plan_matches_the_c_launcher_on_card(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    bad = [shape for shape in LOWLAT_PLAN_SHAPES
           if tlow.plan_ints(tlow.lowlat_plan(*shape[1:5], sms, shape[0],
                                              shape[6], depth=12,
                                              hh=shape[5]))
           != tlow.lowlat_launch_config(*shape[1:5], shape[0], shape[6],
                                        depth=12, hh=shape[5])]
    assert not bad


def _deep_case(kernel, b, dh, device, *, depth=12, d=768, tp=200, valid=197,
               int8=False, seed=30):
    """(kernel output, plain output) of one whole-encoder launch on a
    seeded ViT-B tree of ``depth`` layers at head dim ``dh``."""
    heads = d // dh
    tree = _encoder_tree(seed, depth, d, 512 if kernel == "lowlat_e2e" else 0)
    kw = dict(num_heads=heads, valid_len=valid)
    if kernel == "lowlat_batchgrid":
        w, s = tlow.pack_encoder_weights_batchgrid(tree["vit"], depth=depth,
                                                   device=device)
        x = _stream(seed + 1, b, tp, d, device)
        if b > 1:
            x[-1] = 0                              # a zero pad item
        run = lambda: tlow.encoder_forward_lowlat_batchgrid(x, w, s, **kw)
        plain = tlow.encoder_forward_lowlat_batchgrid_plain(x, w, s, **kw)
        return run, plain
    w, s = tlow.pack_encoder_weights(
        tree["vit"], depth=depth, device=device,
        weight_dtype=torch.int8 if int8 else None)
    if kernel == "lowlat_e2e":
        ends = tlow.pack_end_weights(tree, device=device)
        rng = np.random.default_rng(seed + 2)
        xp = torch.tensor(rng.integers(0, 256, (b, tp, d)).astype(
            np.float32), device=device).to(torch.bfloat16)
        xp[:, 0] = 0
        xp[:, valid:] = 0
        return (lambda: tlow.forward_lowlat_e2e(xp, w, s, *ends, **kw),
                tlow.forward_lowlat_e2e_plain(xp, w, s, *ends, **kw))
    x = _stream(seed + 1, b, tp, d, device)
    return (lambda: tlow.encoder_forward_lowlat(x, w, s, **kw),
            tlow.encoder_forward_lowlat_plain(x, w, s, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("kernel,b", [("lowlat_e2e", 1), ("lowlat_encoder", 1)]
                         + [("lowlat_batchgrid", c) for c in (1, 2, 3, 4)])
def test_lowlat_kernels_at_full_depth_match_plain_on_card(cuda_device,
                                                          kernel, b, dh):
    """Both kernels at 12 ViT-B layers (fold-ends, encoder-only, batch-grid
    chunks 1-4): within 2 bf16 ulps a layer of the plain version, two
    launches bit-equal (the split-K sums are taken in slot order), one
    launch counted each."""
    run, want = _deep_case(kernel, b, dh, cuda_device)
    name = "lowlat_batchgrid" if kernel == "lowlat_batchgrid" else (
        "lowlat_encoder")
    n0 = tatt.LAUNCHES[name]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert tatt.LAUNCHES[name] == n0 + 2
    _assert_close_layers(got, want, 12)
    assert torch.equal(got, again)


# ragged shapes: Tp 40 (valid 33) at D 96 (a K chunk of 96: a 64-deep and
# a 32-deep k-tile), Tp 584 (ViT-B/16 at 384 px: K and V in two key tiles
# at head dim 64, one at 32), D 64 at head dim 16, Tp 64 at ViT-B width
# (one m-group: proj and fc2 at their most K slices); with the int8 stream
@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b,int8", [
    ("lowlat_encoder", 1, False), ("lowlat_encoder", 2, True),
    ("lowlat_encoder", 3, False), ("lowlat_batchgrid", 3, False),
    ("lowlat_batchgrid", 4, False)])
@pytest.mark.parametrize("tp,valid,d,dh,depth", [
    (40, 33, 96, 32, 2), (584, 577, 768, 64, 1), (584, 577, 768, 32, 1),
    (48, 41, 64, 16, 2), (64, 57, 768, 64, 1)])
def test_lowlat_kernels_at_ragged_shapes_match_plain_on_card(
        cuda_device, kernel, b, int8, tp, valid, d, dh, depth):
    run, want = _deep_case(kernel, b, dh, cuda_device, depth=depth, d=d,
                           tp=tp, valid=valid, int8=int8, seed=40)
    got, again = run(), run()
    torch.cuda.synchronize()
    _assert_close_layers(got, want, depth)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_lowlat_serving_launches_one_per_forward_or_chunk(cuda_device):
    """The serving wrappers over the kernels: one launch of kernel 10 a
    B = 1 forward, ceil(B / 2) of kernel 11 a batch-grid forward."""
    from vit_spoof_detection_pda_tpu_torch.models import fastserve

    tree = _encoder_tree(50, 1, 768, 512)
    prep = fastserve.prepare_lowlat(tree, depth=1, batch_grid=True,
                                    device=cuda_device)
    rng = np.random.default_rng(51)
    u8 = torch.from_numpy(rng.integers(0, 256, (8, 224, 224, 3),
                                       dtype=np.uint8)).to(cuda_device)
    kw = dict(num_heads=12)
    n0 = dict(tatt.LAUNCHES)
    fastserve.serving_forward_lowlat(prep, u8[:1], **kw)
    assert tatt.LAUNCHES["lowlat_encoder"] == n0["lowlat_encoder"] + 1
    for b in (2, 3, 5, 8):
        n0 = dict(tatt.LAUNCHES)
        out = fastserve.serving_forward_lowlat_batch(prep, u8[:b], **kw)
        torch.cuda.synchronize()
        assert out.shape == (b,) and torch.isfinite(out).all()
        assert (tatt.LAUNCHES["lowlat_batchgrid"]
                == n0["lowlat_batchgrid"] + -(-b // 2))
        assert tatt.LAUNCHES["lowlat_encoder"] == n0["lowlat_encoder"]


@pytest.mark.cuda
def test_lowlat_unit_stamps_cover_every_phase(cuda_device):
    """A trace of unit_trace_slots also takes each block's unit stamps:
    every phase has a block that stamped its start and end, in order."""
    w, s = tlow.pack_encoder_weights(_encoder_tree(28, 2, 64)["vit"],
                                     depth=2, device=cuda_device)
    x = _stream(29, 2, 40, 64, cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = tlow.lowlat_plan(2, 40, 64, 4, sms, "lowlat_encoder", depth=2)
    trace = torch.zeros(tlow.unit_trace_slots(plan), dtype=torch.int64,
                        device=cuda_device)
    got = tlow.encoder_forward_lowlat(x, w, s, trace=trace, num_heads=4,
                                      valid_len=33)
    want = tlow.encoder_forward_lowlat(x, w, s, num_heads=4, valid_len=33)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    n = plan["trace_slots"]
    units = trace[n:].view(n, plan["grid"], 6).cpu()
    for ph in range(len(plan["phases"])):
        u = units[ph]
        done = u[:, 0] > 0
        assert done.any()
        assert (u[done, 4] >= u[done, 0]).all()


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


def _gather_case(case, device):
    """(pool, host indices) of a case."""
    rng = np.random.default_rng(33)
    if case == "unaligned_base":
        # rows of 3,072 bytes on a base one byte past 16-byte alignment
        flat = torch.tensor(rng.integers(0, 256, 40 * 3072 + 1),
                            dtype=torch.uint8, device=device)
        pool, b = flat[1:].view(40, 32, 32, 3), 50
    else:
        shape, dtype, b = {
            "b1": ((300, 224, 224, 3), torch.uint8, 1),
            "b128": ((300, 224, 224, 3), torch.uint8, 128),
            "b300": ((300, 224, 224, 3), torch.uint8, 300),
            "rows_3072_bytes": ((40, 32, 32, 3), torch.uint8, 50),
            "rows_16_bytes": ((1000, 16), torch.uint8, 300),
            "f32_rows": ((11, 2, 128), torch.float32, 128),
            "rows_105_bytes": ((37, 5, 7, 3), torch.uint8, 128),
        }[case]
        pool = torch.tensor(rng.integers(0, 256, shape), dtype=dtype,
                            device=device)
    idx = rng.integers(0, pool.shape[0], b)
    idx[1::4] = idx[0]                  # repeated indices
    return pool, idx


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b1", "b128", "b300", "rows_3072_bytes",
                                  "rows_16_bytes", "f32_rows",
                                  "rows_105_bytes", "unaligned_base"])
def test_pool_gather_cases_match_plain_on_card(cuda_device, case):
    """Kernel 14 byte for byte, with repeated indices: its 16-byte loop
    (B = 1, 128 and 300 faces; 3 KB and 16-byte rows; f32 rows) and its
    byte loop (105-byte rows, an unaligned base); one launch a call."""
    pool, idx = _gather_case(case, cuda_device)
    want = tgather.pool_gather_plain(pool, idx)
    n0 = tatt.LAUNCHES["pool_gather"]
    got = tgather.pool_gather(pool, idx)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["pool_gather"] == n0 + 1
    assert torch.equal(got, want)
    for _ in range(2):
        tgather.pool_gather(pool, idx)
    assert tatt.LAUNCHES["pool_gather"] == n0 + 3


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


# kernel 15's routes (ops/warp.py::warp_pass_plan): (b, h, w, c, kmax,
# field limit, field kind); "wrap": kmax near half the line, so taps wrap;
# "rows" / "cols": the rotation's broadcast per-row / per-column shifts;
# "wide": lines past the staged routes' shared memory (per pixel)
WARP_ROUTE_CASES = {
    "c1": (3, 64, 48, 1, 9, 8.9, "full"),
    "c2": (3, 64, 48, 2, 9, 8.9, "full"),
    "c4": (3, 64, 48, 4, 9, 8.9, "full"),
    "ragged_250x190": (3, 250, 190, 3, 13, 12.5, "full"),
    "wrap": (2, 40, 36, 3, 18, 17.9, "full"),
    "broadcast_rows": (3, 224, 224, 3, 11, 10.9, "rows"),
    "broadcast_cols": (3, 224, 224, 3, 21, 20.9, "cols"),
    "wide": (1, 3, 9000, 4, 9, 8.9, "full"),
}


def _warp_case(case, dtype, device):
    b, h, w, c, kmax, lim, kind = WARP_ROUTE_CASES[case]
    rng = np.random.default_rng(34)
    img = torch.tensor(rng.random((b, h, w, c), dtype=np.float32),
                       device=device).to(dtype)
    field = torch.tensor((rng.random((b, h, w)) * 2 - 1).astype(np.float32)
                         * lim, device=device)
    if kind == "rows":
        field = field[:, :, :1].expand(b, h, w)
    elif kind == "cols":
        field = field[:, :1, :].expand(b, h, w)
    return img, field, kmax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("along_y", [False, True])
@pytest.mark.parametrize("case", list(WARP_ROUTE_CASES))
def test_warp_pass_routes_match_plain_on_card(cuda_device, dtype, along_y,
                                              case):
    """Kernel 15 bit for bit on the route its plan gives each case (C 1,
    2 and 4, lines off the 16-byte grid, wrapping taps, broadcast fields,
    a line past the staged routes); one launch a call."""
    img, field, kmax = _warp_case(case, dtype, cuda_device)
    b, h, w, c = img.shape
    want = twarp.warp_pass_plain(img, field.contiguous(), kmax,
                                 along_y=along_y)
    plan = twarp.warp_pass_plan(b, h, w, c, dtype, along_y)
    assert plan["route"] == ("per_pixel" if case == "wide" else
                             "cols_direct" if along_y else "rows_staged")
    n0 = tatt.LAUNCHES["warp_pass"]
    got = twarp.warp_pass(img, field, kmax, along_y=along_y)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["warp_pass"] == n0 + 1
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_warp_pass_plan_matches_the_c_launcher_on_card(cuda_device):
    """The plan in Python against the C launcher's own
    (``vsd_warp_pass_plan``) at every case, both types and directions."""
    for b, h, w, c, *_ in WARP_ROUTE_CASES.values():
        for dtype in (torch.float32, torch.bfloat16):
            for along_y in (False, True):
                assert (twarp.warp_pass_c_plan(b, h, w, c, dtype, along_y)
                        == twarp.warp_pass_plan(b, h, w, c, dtype, along_y))


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
    # T 400 f32 and T 801 bf16, refused before, run their key-tiled routes:
    # test_attention_f32_key_tiled_matches_plain_on_card,
    # test_attention_bf16_key_tiled_matches_plain_on_card


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
@pytest.mark.parametrize("approximate", [False, True])
def test_stored_hidden_gelu_at_every_bf16_value_on_card(cuda_device,
                                                        approximate):
    """Kernel 7's fc1 epilogue (the bf16 core's stored-hidden epilogue) on
    one-hot rows whose product is every finite bf16 value: H equal to W's
    row bit for bit (-0 summed to +0), every row's activations alike, each
    within one bf16 ulp of the exact GELU of its flavour (float64, erf by
    erfc, tanh as x sigmoid(2u)); prints how many are one ulp off."""
    r = tgemm.hidden_gelu_check(approximate, cuda_device)
    print("stored-hidden GELU", "tanh" if approximate else "erf", r)
    assert r["values"] == 65280
    assert r["h_bit_equal"] and r["rows_agree"]
    assert r["max_ulps"] <= 1, r


@pytest.mark.cuda
def test_f32_kernels_reject_what_they_cannot_take(cuda_device):
    qkv, g = _f32(_qkv_bwd_inputs(25, cuda_device, 1, 400, 197, 768))
    with pytest.raises(ValueError, match="head dim"):  # Tp 400 now routes
        tatt.attention_qkv_bwd(qkv, g, 32, valid_len=197)     # head dim 24
    xh, inv, dxn, g, lns = _ln_bwd_inputs(26, cuda_device, 1, 8, 64,
                                          torch.bfloat16)
    with pytest.raises(TypeError, match="f32"):      # f32 xh, bf16 dxn
        tln.ln_residual_bwd(xh.float(), inv, dxn, g.float(), lns)
    m = _mlp_inputs(27, cuda_device, 1, 8, 64, 256)
    x, *w = m.values()
    with pytest.raises(TypeError):                   # f32 x, bf16 weights
        tatt.mlp_block_train(x[0].float(), *w, approximate=False)


# kernel 6 on its card-sized grid: (B, Tq, D) -- rows fewer than the SMs,
# rows off a block's run (25,599), D 8 / 776 / 1024, B 256 at ViT-B
LN_GRID_CASES = [(1, 8, 768), (1, 25599, 768), (4, 40, 8), (4, 40, 776),
                 (4, 40, 1024), (256, 200, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "bf16_f32dxn", "f32"])
@pytest.mark.parametrize("b,tq,d", LN_GRID_CASES)
def test_ln_res_bwd_grid_matches_plain_on_card(cuda_device, b, tq, d, form):
    """Kernel 6 against its plain version (bf16 at 2 bf16 ulps, f32 at
    1e-5 of each output's largest magnitude), pad rows exactly 0, the
    sums bit for bit over two calls, one launch a call, a grid of at most
    one wave of the card and the ticket counters left at 0."""
    xh, inv, dxn, g, lns = _ln_bwd_inputs(
        28, cuda_device, b, tq, d,
        torch.bfloat16 if form == "bf16" else torch.float32)
    if form == "f32":
        xh, g = xh.float(), g.float()
    valid = max(1, tq - 3)
    dxn[:, valid:] = 0                      # padding contract
    g[:, valid:] = 0
    name = "ln_res_bwd_f32" if form == "f32" else "ln_res_bwd"
    n0 = tatt.LAUNCHES[name]
    got = tln.ln_residual_bwd(xh, inv, dxn, g, lns)
    assert tatt.LAUNCHES[name] == n0 + 1
    again = tln.ln_residual_bwd(xh, inv, dxn, g, lns)
    assert tatt.LAUNCHES[name] == n0 + 2
    want = tln.ln_residual_bwd_plain(xh, inv, dxn, g, lns)
    torch.cuda.synchronize()
    close = _assert_close_f32 if form == "f32" else _assert_close
    for gg, ww in zip(got, want):           # dx, dscale, dbias
        assert gg.dtype == ww.dtype
        close(gg, ww)
    assert (got[0][:, valid:] == 0).all()
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    plan = tln.ln_bwd_plan(b * tq, d, form != "bf16", form == "f32",
                           cuda_device)
    assert 1 <= plan["blocks"] <= plan["per_sm"] * plan["sms"]
    assert plan["blocks"] <= max(1, -(-(b * tq) // 16))
    assert plan["finishers"] == min(plan["blocks"], 128, 2 * d)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    tickets = tln._tickets[(torch.device(cuda_device).index or 0, stream)]
    assert int(tickets.abs().sum()) == 0


# --------------------------------------------------------------------------
# The phased attention backward (kernel 5) and the doctor's probe (17)
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,tp,valid,d,heads", [
    (torch.bfloat16, 2, 40, 33, 64, 4),      # ragged, head dim 16
    (torch.bfloat16, 3, 200, 197, 768, 12),  # ViT-B/16, odd B
    (torch.bfloat16, 17, 200, 197, 768, 12),  # B = 17
    (torch.bfloat16, 1, 200, 197, 768, 12),  # B = 1
    (torch.bfloat16, 2, 37, 30, 64, 4),      # Tp not a multiple of 16 (or 8)
    (torch.bfloat16, 2, 64, 60, 64, 4),      # the 64-key instance's largest Tp
    (torch.bfloat16, 2, 128, 120, 128, 4),   # the 128-key instance's largest
    (torch.bfloat16, 2, 208, 197, 768, 12),  # the 208-key instance's largest
    (torch.bfloat16, 2, 208, 200, 64, 4),    # ... at head dim 16
    (torch.bfloat16, 2, 209, 197, 768, 12),  # one past it: key-tiled
    (torch.bfloat16, 2, 40, 33, 256, 2),     # head dim 128: key-tiled
    (torch.bfloat16, 1, 908, 900, 64, 4),    # the old long route's largest Tp
    (torch.bfloat16, 1, 909, 909, 64, 4),    # one past it (refused before)
    (torch.float32, 2, 40, 33, 64, 4),
    (torch.float32, 2, 200, 197, 768, 12),
    (torch.float32, 1, 37, 30, 64, 4),       # B = 1, Tp not a multiple of 4
    (torch.float32, 2, 256, 250, 768, 12),   # the 256-key f32 instance's largest
    (torch.float32, 2, 257, 250, 768, 12),   # one past it: the 320-key instance
    (torch.float32, 2, 40, 33, 96, 2),       # head dim 48: key-tiled
])
def test_attention_qkv_bwd_phased_kernel_matches_plain_on_card(
        cuda_device, dtype, b, tp, valid, d, heads):
    """Kernel 5 on the route its shape takes (phased_plan): bf16 within 2
    ulps, f32 within 1e-5 of each part's largest magnitude; every row at
    or past valid_len exactly 0 (the pad rows' dq, the masked keys' dk
    and dv)."""
    rng = np.random.default_rng(40)
    qkv = torch.tensor(rng.standard_normal((b, tp, 3 * d)).astype(np.float32),
                       device=cuda_device, dtype=dtype)
    g = torch.tensor(rng.standard_normal((b, tp, d)).astype(np.float32),
                     device=cuda_device, dtype=dtype)
    g[:, valid:] = 0
    plan = tatt.phased_plan(b, tp, heads, d // heads, dtype)
    name = ("attention_bwd_tiled" if plan["route"] == "key_tiled" else
            "attention_qkv_bwd_phased") + (
                "_f32" if dtype == torch.float32 else "")
    n0 = dict(tatt.LAUNCHES)
    got = tatt.attention_qkv_bwd_phased(qkv, g, heads, valid_len=valid)
    want = tatt.attention_qkv_bwd_plain(qkv, g, heads, valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {**n0, name: n0[name] + 1}
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
def test_attention_qkv_bwd_phased_rejects_what_it_cannot_take(cuda_device):
    """Tp 909 (refused before) is a match case above; what still raises:
    valid_len, the head dim, the dtype."""
    qkv = torch.zeros((1, 909, 192), device=cuda_device, dtype=torch.bfloat16)
    g = torch.zeros((1, 909, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="valid_len"):
        tatt.attention_qkv_bwd_phased(qkv, g, 4, valid_len=910)
    with pytest.raises(ValueError, match="multiple of 16"):     # head dim 8
        tatt.attention_qkv_bwd_phased(qkv[:, :40], g[:, :40], 8, valid_len=40)
    with pytest.raises(TypeError):
        tatt.attention_qkv_bwd_phased(qkv.half(), g.half(), 4, valid_len=909)


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
@pytest.mark.parametrize("case", ["8x128", "3x5", "unaligned_base"])
def test_doctor_probe_shapes_on_card(cuda_device, case):
    """Kernel 17 exactly on [8, 128], on [3, 5] (a ragged block) and on a
    contiguous slice whose base is 4 bytes past 16-byte alignment; one
    launch a call."""
    from vit_spoof_detection_pda_tpu_torch.ops import probe

    rng = np.random.default_rng(34)
    if case == "unaligned_base":
        x = torch.tensor(rng.standard_normal(1025).astype(np.float32),
                         device=cuda_device)[1:]
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    else:
        shape = (8, 128) if case == "8x128" else (3, 5)
        x = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device=cuda_device)
    n0 = probe.LAUNCHES["doctor_probe"]
    got = probe.doctor_probe(x)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["doctor_probe"] == n0 + 1
    assert torch.equal(got, probe.doctor_probe_plain(x))


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


# --------------------------------------------------------------------------
# kernels 12 and 13: the sequence-parallel rectangular attention
# --------------------------------------------------------------------------

# (dtype, b, tq, tk, valid, heads, dh): the SP step's blocks at ViT-B with
# two and four sequence ranks, the f32 shape, an odd shape (no multiple of
# 8 or 16 on either side) and a small ragged one; kernel 12's one-pass
# limit (Tk 208) and one key past it (kernel 13 in bf16 then takes the
# key-tiled backward, as at four ranks' Tk 224), Tq 52 (four ranks), Tq =
# Tk (two tiles, one warp idle), B = 1
CP_CASES = [(torch.bfloat16, 128, 104, 208, 197, 12, 64),
            (torch.bfloat16, 128, 56, 224, 197, 12, 64),
            (torch.float32, 32, 104, 208, 197, 12, 64),
            (torch.bfloat16, 2, 33, 197, 197, 12, 64),
            (torch.float32, 2, 33, 197, 197, 12, 64),
            (torch.bfloat16, 3, 13, 40, 35, 4, 16),
            (torch.float32, 3, 13, 40, 35, 4, 16),
            (torch.bfloat16, 2, 104, 208, 200, 12, 64),
            (torch.bfloat16, 2, 104, 209, 200, 12, 64),
            (torch.float32, 2, 104, 208, 200, 12, 64),
            (torch.float32, 2, 104, 209, 200, 12, 64),
            (torch.bfloat16, 128, 52, 208, 197, 12, 64),
            (torch.bfloat16, 2, 208, 208, 197, 12, 64),
            (torch.float32, 2, 208, 208, 197, 12, 64),
            (torch.bfloat16, 1, 104, 208, 197, 12, 64),
            (torch.float32, 1, 52, 208, 197, 12, 64)]

def _close(got, want, dtype):
    if dtype == torch.bfloat16:
        _assert_close(got, want)
    else:
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all()
        assert ((got - want).abs().max().item()
                <= 1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,tq,tk,valid,heads,dh", CP_CASES)
def test_attention_cp_kernels_match_plain_on_card(cuda_device, dtype, b, tq,
                                                  tk, valid, heads, dh):
    """Kernel 12 (forward) and kernel 13 (backward) against their plain
    versions: bf16 within 2 ulps, f32 within 1e-5 of the largest output
    magnitude (dq and dkv each); the masked keys' dk and dv exactly 0."""
    rng = np.random.default_rng(60)
    d = heads * dh

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=cuda_device, dtype=dtype)

    q, kv, g = t(b, tq, d), t(b, tk, 2 * d), t(b, tq, d)
    f32 = dtype == torch.float32
    fwd, bwd = (("attention_cp_f32", "attention_cp_bwd_f32") if f32
                else ("attention_cp", "attention_cp_bwd"))
    if tatt.cp_bwd_plan(b, tq, tk, heads, dh, dtype)["route"] == "key_tiled":
        bwd = "attention_cp_bwd_tiled" + ("_f32" if f32 else "")  # bf16 Tk > 208
    n0 = dict(tatt.LAUNCHES)
    got = tatt.fused_attention_qkv_cp(q, kv, heads, valid)
    dq, dkv = tatt.attention_cp_bwd(q, kv, g, heads, valid)
    want = tatt.fused_attention_qkv_cp_plain(q, kv, heads, valid)
    want_dq, want_dkv = tatt.attention_cp_bwd_plain(q, kv, g, heads, valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES[fwd] == n0[fwd] + 1
    assert tatt.LAUNCHES[bwd] == n0[bwd] + 1
    _close(got, want, dtype)
    _close(dq, want_dq, dtype)
    _close(dkv, want_dkv, dtype)
    assert not dkv[:, valid:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,tq,tk,valid,heads,dh", [
    (torch.bfloat16, 1, 16, 800, 700, 12, 64),   # the two-pass form's largest
    (torch.bfloat16, 2, 13, 416, 400, 2, 128),   # ... at head dim 128
    (torch.bfloat16, 2, 104, 208, 200, 2, 128),  # one pass at head dim 128
    (torch.float32, 1, 16, 384, 300, 12, 64),    # the f32 two-pass largest
    (torch.float32, 2, 33, 112, 100, 2, 128),    # f32 one pass, head dim 128
    (torch.float32, 2, 33, 200, 190, 2, 128),    # ... past its shared memory
    (torch.bfloat16, 2, 20, 64, 50, 3, 48),      # head dims 48 and 80
    (torch.float32, 2, 20, 300, 250, 3, 80),
])
def test_attention_cp_forms_match_plain_on_card(cuda_device, dtype, b, tq,
                                                tk, valid, heads, dh):
    """Kernel 12 alone at the shapes kernel 13 does not take: the largest
    Tk of each form and the head dims past 64, against its plain version
    (bf16 within 2 ulps, f32 within 1e-5 of the largest magnitude)."""
    rng = np.random.default_rng(61)
    d = heads * dh
    q, kv = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                          device=cuda_device, dtype=dtype)
             for shape in ((b, tq, d), (b, tk, 2 * d)))
    name = "attention_cp_f32" if dtype == torch.float32 else "attention_cp"
    n0 = tatt.LAUNCHES[name]
    got = tatt.fused_attention_qkv_cp(q, kv, heads, valid)
    want = tatt.fused_attention_qkv_cp_plain(q, kv, heads, valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES[name] == n0 + 1
    _close(got, want, dtype)


@pytest.mark.cuda
def test_attention_cp_kernels_reject_what_they_cannot_take(cuda_device):
    """What still raises: valid_len, mixed dtypes, a head dim that is not
    a multiple of 16.  bf16 head dim 96, Tk 264 and Tk 801, refused
    before, are match cases of test_attention_cp_tiled_routes_match_plain_
    on_card."""
    q = torch.zeros((2, 104, 768), device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros((2, 208, 1536), device=cuda_device,
                     dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="valid_len"):
        tatt.fused_attention_qkv_cp(q, kv, 12, 209)
    with pytest.raises(TypeError):
        tatt.fused_attention_qkv_cp(q, kv.float(), 12, 197)
    with pytest.raises(ValueError, match="head dim"):      # dh 24
        tatt.attention_cp_bwd(q, kv, q, 32, 197)
    with pytest.raises(ValueError, match="head dim"):
        tatt.fused_attention_qkv_cp(q, kv, 32, 197)


# --------------------------------------------------------------------------
# the key-tiled routes: every shape the JAX functions take, past what the
# one-block forms hold (the first shape past each old limit, ViT-B/16 at
# 384 px and at 512 px)
# --------------------------------------------------------------------------


def _randn(rng, shape, dtype, device):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                        device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,tp,valid,d,heads", [
    (torch.bfloat16, 2, 216, 197, 768, 12),   # kernel 4 bf16: first past 208
    (torch.bfloat16, 1, 256, 197, 768, 12),   # refused before (shared memory)
    (torch.float32, 2, 324, 260, 768, 12),    # kernel 4 f32: first past 320
    (torch.float32, 1, 400, 197, 768, 12),    # refused before (shared memory)
    (torch.bfloat16, 2, 40, 33, 256, 2),      # bf16 head dim 128
    (torch.bfloat16, 1, 40, 33, 96, 2),       # bf16 head dim 48
    (torch.bfloat16, 2, 80, 70, 480, 6),      # bf16 head dim 80
    (torch.bfloat16, 8, 584, 577, 768, 12),   # ViT-B/16 at 384 px
    (torch.float32, 2, 584, 577, 768, 12),
    (torch.bfloat16, 1, 1040, 1025, 768, 12),  # ViT-B/16 at 512 px
    (torch.float32, 1, 1040, 1025, 256, 2),   # ... f32, head dim 128
])
def test_attention_qkv_bwd_routes_past_kernel_4_on_card(
        cuda_device, dtype, b, tp, valid, d, heads):
    """attention_qkv_bwd (BWD_PHASED unset) on a shape kernel 4 does not
    hold runs phased_plan's route, the key-tiled backward, and never
    kernel 4: bf16 within 2 ulps, f32 within 1e-5 of each part's largest
    magnitude; rows at or past valid_len exactly 0."""
    rng = np.random.default_rng(70)
    qkv = _randn(rng, (b, tp, 3 * d), dtype, cuda_device)
    g = _randn(rng, (b, tp, d), dtype, cuda_device)
    g[:, valid:] = 0
    plan = tatt.attention_qkv_bwd_plan(b, tp, heads, d // heads, dtype)
    assert plan["route"] == "key_tiled"
    name = "attention_bwd_tiled" + ("_f32" if dtype == torch.float32 else "")
    n0 = dict(tatt.LAUNCHES)
    got = tatt.attention_qkv_bwd(qkv, g, heads, valid_len=valid)
    want = tatt.attention_qkv_bwd_plain(qkv, g, heads, valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {**n0, name: n0[name] + 1}
    assert (got[:, valid:] == 0).all()
    for i in range(3):
        _close(got[..., i * d:(i + 1) * d], want[..., i * d:(i + 1) * d],
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads", [
    (2, 336, 330, 768, 12),     # the f32 blocks: first Tp past 328
    (2, 584, 577, 768, 12),     # ViT-B/16 at 384 px
    (1, 1040, 1025, 256, 2),    # 512 px rows at head dim 128
])
def test_attention_block_f32_key_tiled_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads):
    """Kernels 1 and 3 at f32 past the Tp whose K and V fit a block: the
    key-tiled core, within 1e-5 of each output's largest magnitude."""
    a = _attn_inputs(71, cuda_device, b, tp, d)
    x, *w = _f32(a.values())
    assert tatt.module_attention_plan(tp, d // heads, torch.float32)[
        "form"] == "key_tiled"
    n0 = dict(tatt.LAUNCHES)
    got = tatt.attention_block_train_padded(x, *w, heads, valid_len=valid)
    out = tatt.fused_attention_block_padded(x, *w, heads, valid_len=valid)
    want = tatt.attention_block_train_padded_plain(x, *w, heads,
                                                   valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {
        **n0,
        "attention_block_train_f32_tiled":
            n0["attention_block_train_f32_tiled"] + 1,
        "attention_block_f32_tiled": n0["attention_block_f32_tiled"] + 1}
    for gg, ww in zip(got, want):          # out, qkv, attn, xhat, inv
        _assert_close_f32(gg, ww)
    assert torch.equal(out, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,heads,dh", [
    (2, 334, 12, 64),     # kernels 8 and 9 f32: first T past 333
    (2, 577, 12, 64),     # ViT-B/16 at 384 px
    (1, 1025, 2, 128),    # 512 px at head dim 128
    (2, 420, 3, 48),      # head dim 48 past its whole-K/V limit (416)
])
def test_attention_f32_key_tiled_matches_plain_on_card(cuda_device, b, t,
                                                       heads, dh):
    """Kernel 8 (fused qkv) and kernel 9 (strided q/k/v views) at f32 on
    the key-tiled core, within 1e-5 of the largest output magnitude."""
    rng = np.random.default_rng(72)
    x = _randn(rng, (b, t, 3, heads, dh), torch.float32, cuda_device)
    assert tatt.module_attention_plan(t, dh, torch.float32)[
        "form"] == "key_tiled"
    n0 = dict(tatt.LAUNCHES)
    qkv = x.reshape(b, t, 3 * heads * dh)
    got8 = tatt.fused_attention_qkv(qkv, heads)
    q, k, v = x.unbind(2)
    got9 = tatt.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {
        **n0, "attention_qkv_f32_tiled": n0["attention_qkv_f32_tiled"] + 1,
        "attention_f32_tiled": n0["attention_f32_tiled"] + 1}
    _assert_close_f32(got8, tatt.fused_attention_qkv_plain(qkv, heads))
    _assert_close_f32(got9, tatt.fused_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,tq,tk,valid,heads,dh", [
    (torch.float32, 2, 40, 385, 380, 12, 64),    # kernel 12 f32: first past 384
    (torch.float32, 2, 40, 201, 190, 2, 128),    # ... at head dim 128: past 200
    (torch.bfloat16, 1, 16, 801, 700, 12, 64),   # bf16: first past 800
    (torch.bfloat16, 2, 40, 264, 250, 12, 64),   # kernel 13 bf16: past 256
    (torch.bfloat16, 2, 40, 120, 110, 8, 96),    # kernel 13 bf16 head dim 96
    (torch.float32, 2, 40, 324, 260, 12, 64),    # kernel 13 f32: past 320
    (torch.bfloat16, 2, 296, 592, 577, 12, 64),  # 384 px at two seq ranks
    (torch.float32, 2, 296, 592, 577, 12, 64),
    (torch.bfloat16, 1, 520, 1040, 1025, 12, 64),  # 512 px at two ranks
])
def test_attention_cp_tiled_routes_match_plain_on_card(
        cuda_device, dtype, b, tq, tk, valid, heads, dh):
    """Kernels 12 and 13 on the routes cp_plan and cp_bwd_plan give shapes
    their one-block forms do not hold (kernel 12 key-tiled past its K and
    V, kernel 13 on the rectangular key-tiled backward): bf16 within 2
    ulps, f32 within 1e-5 of the largest magnitude; masked keys' dk and dv
    exactly 0."""
    rng = np.random.default_rng(73)
    d = heads * dh
    q, kv, g = (_randn(rng, s, dtype, cuda_device)
                for s in ((b, tq, d), (b, tk, 2 * d), (b, tq, d)))
    f32 = "_f32" if dtype == torch.float32 else ""
    fwd = "attention_cp" + (
        "_tiled" if tatt.cp_plan(tq, tk, dh, dtype)["form"] == "key_tiled"
        else "") + f32
    bwd = "attention_cp_bwd" + (
        "_tiled" if tatt.cp_bwd_plan(b, tq, tk, heads, dh, dtype)["route"]
        == "key_tiled" else "") + f32
    assert "_tiled" in fwd + bwd
    n0 = dict(tatt.LAUNCHES)
    got = tatt.fused_attention_qkv_cp(q, kv, heads, valid)
    dq, dkv = tatt.attention_cp_bwd(q, kv, g, heads, valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {**n0, fwd: n0[fwd] + 1, bwd: n0[bwd] + 1}
    want_dq, want_dkv = tatt.attention_cp_bwd_plain(q, kv, g, heads, valid)
    _close(got, tatt.fused_attention_qkv_cp_plain(q, kv, heads, valid), dtype)
    _close(dq, want_dq, dtype)
    _close(dkv, want_dkv, dtype)
    assert not dkv[:, valid:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,heads,dh", [
    (2, 801, 12, 64),     # kernels 8 and 9 bf16: first T past 800
    (1, 1025, 12, 64),    # ViT-B/16 at 512 px
    (2, 417, 2, 128),     # head dim 128: first T past 416
])
def test_attention_bf16_key_tiled_matches_plain_on_card(cuda_device, b, t,
                                                        heads, dh):
    """Kernel 8 (fused qkv) and kernel 9 (strided q/k/v views) at bf16
    past one head's K and V: kernel 12's key-tiled two passes, within 2
    bf16 ulps of the largest output magnitude."""
    rng = np.random.default_rng(74)
    x = _randn(rng, (b, t, 3, heads, dh), torch.bfloat16, cuda_device)
    assert tatt.module_attention_plan(t, dh, torch.bfloat16)[
        "form"] == "key_tiled"
    n0 = dict(tatt.LAUNCHES)
    qkv = x.reshape(b, t, 3 * heads * dh)
    got8 = tatt.fused_attention_qkv(qkv, heads)
    q, k, v = x.unbind(2)
    got9 = tatt.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {
        **n0, "attention_qkv_tiled": n0["attention_qkv_tiled"] + 1,
        "attention_tiled": n0["attention_tiled"] + 1}
    _assert_close(got8, tatt.fused_attention_qkv_plain(qkv, heads))
    _assert_close(got9, tatt.fused_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("b,tp,valid,d,heads", [
    (2, 808, 801, 768, 12),     # the bf16 blocks: first Tp past 800
    (1, 1040, 1025, 768, 12),   # ViT-B/16 at 512 px
])
def test_attention_block_bf16_key_tiled_matches_plain_on_card(
        cuda_device, b, tp, valid, d, heads):
    """Kernels 1 and 3 at bf16 past one head's K and V (their attention
    stage on kernel 12's key tiles): within 2 bf16 ulps of each output's
    largest magnitude."""
    a = _attn_inputs(75, cuda_device, b, tp, d)
    assert tatt.module_attention_plan(tp, d // heads, torch.bfloat16)[
        "form"] == "key_tiled"
    n0 = dict(tatt.LAUNCHES)
    got = tatt.attention_block_train_padded(*a.values(), heads,
                                            valid_len=valid)
    out = tatt.fused_attention_block_padded(*a.values(), heads,
                                            valid_len=valid)
    want = tatt.attention_block_train_padded_plain(*a.values(), heads,
                                                   valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {
        **n0, "attention_block_train_tiled":
            n0["attention_block_train_tiled"] + 1,
        "attention_block_tiled": n0["attention_block_tiled"] + 1}
    for gg, ww in zip(got, want):          # out, qkv, attn, xhat, inv
        if gg.dtype == torch.bfloat16:
            _assert_close(gg, ww)
        else:
            _assert_close_f32(gg, ww)
    _assert_close(out, want[0])


# Kernels 8 and 9 on every route of module_attention_plan: ViT-B/16 at
# 224 px (B 128, T 197), T 1 and 17 (a tile mostly of idle rows), the
# one-pass limit (208 keys) and one past it, 256 / 288 / 384 px (T 257,
# 325, 577), head dims 16 and 128 (at 128 the f32 one-pass block fits only
# up to 112 keys)
MODULE_CASES = [(128, 197, 12, 64), (2, 1, 12, 64), (3, 17, 12, 64),
                (2, 208, 12, 64), (2, 209, 12, 64), (2, 257, 12, 64),
                (2, 325, 12, 64), (2, 577, 12, 64), (2, 197, 4, 16),
                (2, 112, 2, 128), (2, 208, 2, 128), (2, 209, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,heads,dh", MODULE_CASES)
def test_module_attention_routes_match_plain_on_card(cuda_device, dtype, b,
                                                     t, heads, dh):
    """Kernel 8 on the fused projection and kernel 9 on strided views of
    the same [B, T, 3D] tensor (the int8 path's q/k/v, row stride 3D), one
    launch each on the route module_attention_plan names: bf16 within 2
    ulps, f32 within 1e-5 of the largest output magnitude."""
    rng = np.random.default_rng(b * t + dh)
    x = _randn(rng, (b, t, 3, heads, dh), dtype, cuda_device)
    f32 = dtype == torch.float32
    tiled = tatt.module_attention_plan(t, dh, dtype)["form"] == "key_tiled"
    name8 = "attention_qkv" + (("_f32_tiled" if f32 else "_tiled")
                               if tiled else "")
    name9 = ("attention_f32" if f32 else "attention") + (
        "_tiled" if tiled else "")
    n0 = dict(tatt.LAUNCHES)
    qkv = x.reshape(b, t, 3 * heads * dh)
    got8 = tatt.fused_attention_qkv(qkv, heads)
    q, k, v = x.unbind(2)
    got9 = tatt.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {**n0, name8: n0[name8] + 1,
                             name9: n0[name9] + 1}
    _close(got8, tatt.fused_attention_qkv_plain(qkv, heads), dtype)
    _close(got9, tatt.fused_attention_plain(q, k, v), dtype)


# --------------------------------------------------------------------------
# kernels 4, 5 and 13 on the one-launch on-chip core
# (csrc/attention_bwd_onchip.cuh) and the first shape past each of its
# limits (the key-tiled backward there)
# --------------------------------------------------------------------------

# (Tq, Tk): one query tile against the 208 keys a warp holds, the 2-rank
# sequence-parallel block, the 4-rank block (224 keys: bf16 past the core),
# Tq past Tk, ViT-B/16 at 256 px against its 2-rank keys, the 384 px block
ONCHIP_RECTS = [(8, 208), (104, 208), (56, 224), (208, 16), (200, 264),
                (296, 592)]
# (dtype, Tq, Tk, dh) at each limit: bf16 Q and G in tiles of their own up
# to Tq 160 at Tk 208, over K and V to Tq 208, past shared memory at 209,
# Tq past the 208 rows part B's loop unrolls (Tq 296 against 16 keys);
# f32 any Tq, Tk up to 320 / 448 / 576 at head dims 64 / 32 / 16
ONCHIP_LIMITS = [(torch.bfloat16, 160, 208, 64), (torch.bfloat16, 176, 208, 64),
                 (torch.bfloat16, 296, 16, 64),
                 (torch.bfloat16, 209, 208, 64), (torch.bfloat16, 40, 209, 64),
                 (torch.bfloat16, 40, 209, 16),
                 (torch.float32, 600, 320, 64), (torch.float32, 40, 321, 64),
                 (torch.float32, 40, 448, 32), (torch.float32, 40, 449, 32),
                 (torch.float32, 40, 576, 16), (torch.float32, 40, 577, 16)]


def _onchip_cp_case(device, dtype, tq, tk, dh):
    """Kernel 13 at (tq, tk), B 2, d = 4 heads of dh (12 of 64): the route
    cp_bwd_plan names, one launch, against its plain version; g zero on
    the last 5 query rows (their dq exactly 0), keys past valid_len = tk -
    7 masked (their dk and dv exactly 0)."""
    rng = np.random.default_rng(80 + tq + tk + dh)
    heads = 12 if dh == 64 else 4
    d, b, valid = heads * dh, 2, max(1, tk - 7)
    q, kv, g = (_randn(rng, s, dtype, device)
                for s in ((b, tq, d), (b, tk, 2 * d), (b, tq, d)))
    g[:, tq - 5:] = 0
    plan = tatt.cp_bwd_plan(b, tq, tk, heads, dh, dtype)
    name = "attention_cp_bwd" + ("_tiled" if plan["route"] == "key_tiled"
                                 else "") + (
        "_f32" if dtype == torch.float32 else "")
    n0 = dict(tatt.LAUNCHES)
    dq, dkv = tatt.attention_cp_bwd(q, kv, g, heads, valid)
    want_dq, want_dkv = tatt.attention_cp_bwd_plain(q, kv, g, heads, valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {**n0, name: n0[name] + 1}
    _close(dq, want_dq, dtype)
    for i in range(2):                       # dk, dv
        _close(dkv[..., i * d:(i + 1) * d], want_dkv[..., i * d:(i + 1) * d],
               dtype)
    assert not dkv[:, valid:].any()
    assert not dq[:, tq - 5:].any()
    return plan["route"]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("tq,tk", ONCHIP_RECTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_cp_bwd_rectangles_match_plain_on_card(cuda_device, dtype,
                                                         tq, tk, dh):
    """Kernel 13 on every rectangle at head dims 16, 32 and 64 (the kv
    halves' batch stride Tk * 2D apart from Tq times their row stride):
    bf16 within 2 ulps, f32 within 1e-5 of each output's largest
    magnitude."""
    _onchip_cp_case(cuda_device, dtype, tq, tk, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tq,tk,dh", ONCHIP_LIMITS)
def test_attention_cp_bwd_at_the_core_limits_on_card(cuda_device, dtype, tq,
                                                     tk, dh):
    """Kernel 13 at each limit of the on-chip core and the first shape
    past it, on the route the plan names."""
    route = _onchip_cp_case(cuda_device, dtype, tq, tk, dh)
    past = (tq, tk) in ((209, 208), (40, 209), (40, 321), (40, 449),
                        (40, 577))
    assert route == ("key_tiled" if past else "on_chip")


# (dtype, Tp, dh): the square on the core and the first Tp past it, at each
# head dim (bf16: 208 keys; f32: 320 / 448 / 576 keys)
ONCHIP_SQUARES = [(torch.bfloat16, 8, 16), (torch.bfloat16, 104, 32),
                  (torch.bfloat16, 208, 64), (torch.bfloat16, 216, 64),
                  (torch.bfloat16, 208, 16), (torch.bfloat16, 216, 16),
                  (torch.float32, 8, 16), (torch.float32, 104, 32),
                  (torch.float32, 264, 64), (torch.float32, 320, 64),
                  (torch.float32, 324, 64), (torch.float32, 448, 32),
                  (torch.float32, 452, 32), (torch.float32, 576, 16),
                  (torch.float32, 580, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("phased", [False, True])
@pytest.mark.parametrize("dtype,tp,dh", ONCHIP_SQUARES)
def test_attention_qkv_bwd_core_limits_on_card(cuda_device, monkeypatch,
                                               dtype, tp, dh, phased):
    """Kernel 4 (BWD_PHASED unset) and kernel 5 (set) on the square, B 2,
    valid_len Tp - 3 (g zero on the pad rows): one launch on the route the
    plan names (the core up to its limit, the key-tiled backward past
    it), bf16 within 2 ulps, f32 within 1e-5 of each part's largest
    magnitude; rows at or past valid_len exactly 0."""
    monkeypatch.setattr(tatt, "BWD_PHASED", phased)
    rng = np.random.default_rng(90 + tp + dh)
    heads = 12 if dh == 64 else 4
    d, b, valid = heads * dh, 2, tp - 3
    qkv = _randn(rng, (b, tp, 3 * d), dtype, cuda_device)
    g = _randn(rng, (b, tp, d), dtype, cuda_device)
    g[:, valid:] = 0
    plan = tatt.attention_qkv_bwd_plan(b, tp, heads, dh, dtype)
    onchip = plan["route"] == "unphased"
    assert onchip == (tp <= (208 if dtype == torch.bfloat16 else
                             {16: 576, 32: 448, 64: 320}[dh]))
    name = ("attention_qkv_bwd" + ("_phased" if phased else "") if onchip
            else "attention_bwd_tiled") + (
        "_f32" if dtype == torch.float32 else "")
    n0 = dict(tatt.LAUNCHES)
    got = tatt.attention_qkv_bwd(qkv, g, heads, valid_len=valid)
    want = tatt.attention_qkv_bwd_plain(qkv, g, heads, valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {**n0, name: n0[name] + 1}
    assert (got[:, valid:] == 0).all()
    for i in range(3):
        _close(got[..., i * d:(i + 1) * d], want[..., i * d:(i + 1) * d],
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_onchip_bwd_plan_matches_the_c_launcher_on_card(cuda_device, dtype,
                                                        dh):
    """The plan of the on-chip backward (instance, warps, shared memory,
    or None) is what its C launcher chooses, read from the library: the
    squares Tp 8-1,040 in steps of 8 and every rectangle above."""
    shapes = [(t, t) for t in range(8, 1041, 8)] + ONCHIP_RECTS + [
        (tq, tk) for _, tq, tk, _ in ONCHIP_LIMITS]
    bad = [(tq, tk, plan, c) for tq, tk in shapes
           if (plan := tatt.onchip_bwd_plan(tq, tk, dh, dtype))
           != (c := tatt.onchip_bwd_launch_config(tq, tk, dh, dtype))]
    assert not bad


# --------------------------------------------------------------------------
# The GEMM cores (csrc/gemm_core.cuh, bf16; csrc/f32_common.cuh, f32) alone,
# and kernels 1 and 3 on the routes of kernels 8 and 9
# --------------------------------------------------------------------------

# ViT-B/16's four products at B = 128 (bf16, M 25,600) and 32 (f32, 6,400),
# the step's unpadded rows (25,216), and ragged M, N and K
GEMM_SHAPES = {
    torch.bfloat16: [(25600, 2304, 768), (25600, 768, 768),
                     (25600, 3072, 768), (25600, 768, 3072),
                     (25216, 2304, 768), (1, 8, 8), (130, 776, 72)],
    torch.float32: [(6400, 2304, 768), (6400, 768, 768), (6400, 3072, 768),
                    (6400, 768, 3072), (1, 8, 8), (130, 776, 72)]}
GEMM_CASES = [(dt, epi, *shape) for dt in (torch.bfloat16, torch.float32)
              for epi in tgemm.EPILOGUES
              if not (dt == torch.float32 and epi == "bias_gelu")
              for shape in GEMM_SHAPES[dt]]


def _gemm_inputs(seed, device, m, n, k, dtype):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=device).to(dt)
    return (t(m, k), t(k, n, scale=k ** -0.5),
            t(n, scale=0.1, dt=torch.float32), t(m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,epilogue,m,n,k", GEMM_CASES)
def test_gemm_core_matches_plain_on_card(cuda_device, dtype, epilogue, m, n,
                                         k):
    """Each core and epilogue against gemm_plain: within 2 bf16 ulps of
    each output's largest magnitude (one rounding apart, sums in other
    f32 orders), f32 within 1e-5 of it."""
    a, w, bias, r = _gemm_inputs(m + n + k, cuda_device, m, n, k, dtype)
    res = r if epilogue == "bias_residual" else None
    name = "gemm_f32" if dtype == torch.float32 else "gemm"
    n0 = dict(tatt.LAUNCHES)
    got = tgemm.gemm(a, w, bias, epilogue=epilogue, residual=res)
    want = tgemm.gemm_plain(a, w, bias, epilogue=epilogue, residual=res)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {**n0, name: n0[name] + 1}
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for gg, ww in zip(got, want):            # C (and H)
        assert gg.dtype == dtype
        (_assert_close if dtype == torch.bfloat16 else _assert_close_f32)(
            gg, ww)


@pytest.mark.cuda
def test_gemm_core_rejects_what_it_cannot_take(cuda_device):
    a, w, bias, _ = _gemm_inputs(1, cuda_device, 64, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tgemm.gemm(a[:, :60], w[:60], bias)
    with pytest.raises(ValueError, match="bias_gelu"):
        tgemm.gemm(a.float(), w.float(), bias, epilogue="bias_gelu")
    with pytest.raises(ValueError, match="residual"):
        tgemm.gemm(a, w, bias, epilogue="bias_residual")
    with pytest.raises(TypeError, match="float16"):
        tgemm.gemm(a.half(), w.half(), bias)


@pytest.mark.cuda
def test_gemm_plan_matches_the_c_launcher_on_card(cuda_device):
    """gemm_plan is what vsd_gemm_plan reports on this card: the four
    ViT-B/16 products at B = 1, 2, 32 and 128, and ragged M, N, K."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    shapes = [(b * 200, n, k) for b in (1, 2, 32, 128)
              for n, k in ((2304, 768), (768, 768), (3072, 768), (768, 3072))
              ] + [(m, n, k) for m in (1, 130, 25216) for n in (8, 776)
                   for k in (8, 72)]
    bad = [(shape, plan, c) for shape in shapes
           if (plan := tgemm.gemm_plan(*shape, sms))
           != (c := tgemm.gemm_launch_config(*shape))]
    assert not bad


# Kernels 1 and 3 at the first Tp past each route limit of the attention
# stage (bf16: one pass to 208 keys, then two passes to 800; f32: one pass
# to 208, the whole f32 core to 328 at head dim 64), ViT-B/16 at 224, 256,
# 384 and 512 px, and head dims 16 to 128
BLOCK_ROUTE_CASES = [
    (2, 208, 205, 768, 12), (2, 216, 209, 768, 12), (2, 800, 795, 768, 12),
    (2, 808, 801, 768, 12), (2, 200, 197, 768, 12), (2, 264, 257, 768, 12),
    (1, 584, 577, 768, 12), (1, 1032, 1025, 768, 12),
    (2, 200, 197, 768, 48), (2, 200, 197, 768, 24), (2, 200, 197, 768, 16),
    (2, 200, 197, 160, 2), (2, 200, 197, 768, 8), (2, 200, 197, 224, 2),
    (2, 264, 257, 768, 6), (2, 336, 330, 768, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,tp,valid,d,heads", BLOCK_ROUTE_CASES)
def test_attention_blocks_on_the_module_routes_match_plain_on_card(
        cuda_device, dtype, b, tp, valid, d, heads):
    """Kernels 1 and 3 take the route module_attention_plan names for
    their attention stage, with the launch counter it names and two
    launches of the GEMM core each; their outputs within 2 bf16 ulps
    (f32: 1e-5) of each output's largest magnitude."""
    a = _attn_inputs(81, cuda_device, b, tp, d)
    x, *w = a.values() if dtype == torch.bfloat16 else _f32(a.values())
    plan = tatt.module_attention_plan(tp, d // heads, dtype)
    sfx = ("_f32" if dtype == torch.float32 else "") + (
        "_tiled" if plan["form"] == "key_tiled" else "")
    core = "gemm_f32" if dtype == torch.float32 else "gemm"
    n0, c0 = dict(tatt.LAUNCHES), tgemm.core_launches()
    got = tatt.attention_block_train_padded(x, *w, heads, valid_len=valid)
    out = tatt.fused_attention_block_padded(x, *w, heads, valid_len=valid)
    want = tatt.attention_block_train_padded_plain(x, *w, heads,
                                                   valid_len=valid)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES == {
        **n0, "attention_block_train" + sfx:
            n0["attention_block_train" + sfx] + 1,
        "attention_block" + sfx: n0["attention_block" + sfx] + 1}
    assert tgemm.core_launches() == {**c0, core: c0[core] + 4}
    for gg, ww in zip(got, want):          # out, qkv, attn, xhat, inv
        if gg.dtype == torch.bfloat16:
            _assert_close(gg, ww)
        else:
            _assert_close_f32(gg, ww)
    if dtype == torch.bfloat16:
        _assert_close(out, want[0])
    else:
        assert torch.equal(out, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,hidden", [(128, 200, 768, 3072),
                                          (3, 197, 768, 3072),
                                          (2, 33, 64, 256)])
def test_mlp_blocks_count_two_core_launches_on_card(cuda_device, b, t, d,
                                                    hidden):
    """Kernels 2 and 7 (bf16 and f32) follow the GEMM core: two launches
    of it a call, outputs within 2 bf16 ulps (f32: 1e-5) of plain."""
    m = _mlp_inputs(41, cuda_device, b, t, d, hidden)
    c0 = tgemm.core_launches()
    got = tatt.fused_mlp_block(*m.values())
    _assert_close(got, tatt.fused_mlp_block_plain(*m.values()))
    x, *w = _f32(m.values())
    rows = x.reshape(-1, d)
    y = tatt.mlp_block_train(rows, *w, approximate=False)
    want = tatt.mlp_block_train_plain(rows, *w, approximate=False)
    torch.cuda.synchronize()
    assert tgemm.core_launches() == {"gemm": c0["gemm"] + 2,
                                   "gemm_f32": c0["gemm_f32"] + 2}
    for gg, ww in zip(y, want):
        _assert_close_f32(gg, ww)


# --------------------------------------------------------------------------
# kernels 2 and 16 at the edges of their plans
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 127, 129, 25216])
def test_mlp_kernel_row_counts_match_plain_on_card(cuda_device, rows):
    """Kernel 2 at ViT-B widths on one row, either side of a 128-row GEMM
    tile and the training step's 25,216 rows: one launch, two of the GEMM
    core, within 2 bf16 ulps of plain."""
    m = _mlp_inputs(90 + rows % 7, cuda_device, 1, rows, 768, 3072)
    n0, c0 = tatt.LAUNCHES["mlp_block"], tgemm.core_launches()
    got = tatt.fused_mlp_block(*m.values())
    want = tatt.fused_mlp_block_plain(*m.values())
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["mlp_block"] == n0 + 1
    assert tgemm.core_launches()["gemm"] == c0["gemm"] + 2
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,r,p", [
    (1, 6, 9, 3, 5, 1),          # smaller than the search window
    (2, 6, 9, 1, 5, 2),
    (2, 40, 33, 3, 0, 1),        # r 0
    (2, 40, 33, 3, 5, 0),        # p 0
    (2, 224, 224, 3, 0, 0),
    (2, 97, 133, 1, 5, 1),       # C 1, 2 and 4
    (2, 80, 70, 2, 3, 1),
    (1, 100, 70, 4, 5, 1),
    (1, 64, 50, 4, 3, 3),        # the staged route
    (1, 40, 35, 2, 4, 5),
])
def test_nlm_kernel_edge_shapes_match_plain_on_card(cuda_device, b, h, w, c,
                                                    r, p):
    rng = np.random.default_rng(h * w + c + r)
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
def test_mlp_and_nlm_plans_match_the_c_launchers_on_card(cuda_device):
    """mlp_block_plan and nlm_plan are what vsd_mlp_block_plan and
    vsd_nlm_plan report on this card."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for rows, d, hidden in ((1, 768, 3072), (127, 768, 3072),
                            (129, 768, 3072), (25216, 768, 3072),
                            (25600, 768, 3072), (66, 40, 72)):
        plan = tatt.mlp_block_plan(rows, d, hidden, sms)
        del plan["scratch"]
        assert plan == tatt.mlp_block_launch_config(rows, d, hidden)
    for shape in ((224, 224, 3, 5, 1), (250, 190, 3, 5, 1), (6, 9, 3, 5, 1),
                  (20, 17, 1, 2, 2), (224, 224, 3, 0, 0), (80, 70, 4, 3, 1),
                  (64, 64, 3, 5, 3), (512, 512, 4, 40, 1)):
        assert tnlm.nlm_plan(*shape) == tnlm.nlm_c_plan(*shape)


@pytest.mark.cuda
@pytest.mark.parametrize("c,p", [(c, p) for c in (1, 2, 3, 4)
                                 for p in (0, 1, 2)])
def test_nlm_division_equals_fdiv_rn_at_every_input_on_card(cuda_device, c,
                                                           p):
    """Where the plan names the fast division (an odd norm (2p + 1)^2 C or
    a power of two), the register route's multiply and one correction
    equal __fdiv_rn bit for bit at each of the 2^32 f32 inputs; where it
    does not (C 2 or 4 with p >= 1), some input differs, so __fdiv_rn
    stays there."""
    count, first = tnlm.nlm_div_check((2 * p + 1) ** 2 * c)
    if tnlm.nlm_plan(32, 32, c, 1, p)["fast_div"]:
        assert (count, first) == (0, 2 ** 32)
    else:
        assert count > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 1088])
def test_layernorm_either_side_of_its_register_rows_on_card(cuda_device, d):
    """The LN pass of kernels 2 and 7 holds a row of up to 1,024 values in
    registers and reads a longer one three times: both within 2 bf16 ulps
    of plain (kernel 7's f32 residuals within 1e-5)."""
    m = _mlp_inputs(95, cuda_device, 1, 130, d, 256)
    got = tatt.fused_mlp_block(*m.values())
    _assert_close(got, tatt.fused_mlp_block_plain(*m.values()))
    x, *w = m.values()
    rows = x.reshape(-1, d)
    y = tatt.mlp_block_train(rows, *w, approximate=True)
    want = tatt.mlp_block_train_plain(rows, *w, approximate=True)
    torch.cuda.synchronize()
    for gg, ww in zip(y, want):
        (_assert_close if gg.dtype == torch.bfloat16 else _assert_close_f32)(
            gg, ww)


# --------------------------------------------------------------------------
# the linear head's LayerNorm eps (HF 1e-12) through kernels 1, 2 and 10,
# and serving_forward(fuse_mlp=False) on the GEMM core
# --------------------------------------------------------------------------

from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast  # noqa: E402,E501


def _tiny_var_rows(x):
    """Rows 3 and 7 of each item scaled to ~1e-4 (variance ~1e-8), where
    eps 1e-12 and the default 1e-6 give outputs an order of magnitude
    apart: an eps that did not reach the kernel shows."""
    x = x.clone()
    x[:, 3] = (x[:, 3].float() * 1e-4).to(x.dtype)
    x[:, 7] = (x[:, 7].float() * 1e-4).to(x.dtype)
    return x


def _far(got, other):
    """``got`` is further than 4 x the 2-ulp tolerance from ``other`` (the
    plain version at the default eps 1e-6): the eps reached the kernel."""
    got, other = got.float().cpu(), other.float().cpu()
    tol = 2.0 * 2.0 ** (math.floor(math.log2(other.abs().max().item())) - 7)
    return (got - other).abs().max().item() > 4 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["attention_block", "mlp_block"])
def test_serving_blocks_take_eps_1e12_on_card(cuda_device, kernel):
    b, t, d = 2, 197, 768
    tp = tatt._round_up(t, 8)
    if kernel == "attention_block":
        a = _attn_inputs(96, cuda_device, b, tp, d)
        x = _tiny_var_rows(a.pop("x"))

        def run(fn, eps):
            return fn(x, *a.values(), 12, valid_len=t, eps=eps)
        fns = (tatt.fused_attention_block_padded,
               tatt.fused_attention_block_padded_plain)
    else:
        m = _mlp_inputs(97, cuda_device, b, tp, d, 4 * d)
        x = _tiny_var_rows(m.pop("x"))

        def run(fn, eps):
            return fn(x, *m.values(), eps=eps)
        fns = (tatt.fused_mlp_block, tatt.fused_mlp_block_plain)
    n0 = tatt.LAUNCHES[kernel]
    got = run(fns[0], 1e-12)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES[kernel] == n0 + 1
    _assert_close(got, run(fns[1], 1e-12))
    assert _far(got, run(fns[1], 1e-6))


@pytest.mark.cuda
def test_lowlat_encoder_takes_eps_1e12_on_card(cuda_device):
    d, tp, valid = 768, 200, 197
    w, s = tlow.pack_encoder_weights(_encoder_tree(98, 1, d)["vit"],
                                     depth=1, device=cuda_device)
    x = _tiny_var_rows(_stream(99, 1, tp, d, cuda_device))
    n0 = tatt.LAUNCHES["lowlat_encoder"]
    kw = dict(num_heads=12, valid_len=valid)
    got = tlow.encoder_forward_lowlat(x, w, s, eps=1e-12, **kw)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["lowlat_encoder"] == n0 + 1
    _assert_close_layers(
        got, tlow.encoder_forward_lowlat_plain(x, w, s, eps=1e-12, **kw), 1)
    assert _far(got, tlow.encoder_forward_lowlat_plain(x, w, s, eps=1e-6,
                                                       **kw))


@pytest.mark.cuda
def test_unfused_mlp_serving_forward_launches_the_gemm_core(cuda_device):
    """serving_forward(fuse_mlp=False): per layer kernel 1 once and the
    GEMM core alone twice (fc1 with the GELU, fc2 with the residual),
    kernel 2 never; the cores' own count 4 a layer, as the fused forward's;
    scores within the bf16 serving bound (5e-2) of the fused forward."""
    depth = 2
    tree = _encoder_tree(100, depth, 768, hh=64)
    params = tfast.prepare_params(tree, dtype=torch.bfloat16,
                                  device=cuda_device)
    u8 = torch.from_numpy(np.random.default_rng(101).integers(
        0, 256, (4, 224, 224, 3), dtype=np.uint8)).to(cuda_device)
    fused = tfast.serving_forward(params, u8, depth=depth)
    torch.cuda.synchronize()
    before = dict(tatt.LAUNCHES)
    tgemm.core_launches(reset=True)
    got = tfast.serving_forward(params, u8, depth=depth, fuse_mlp=False)
    torch.cuda.synchronize()
    delta = {k: tatt.LAUNCHES[k] - before.get(k, 0) for k in tatt.LAUNCHES
             if tatt.LAUNCHES[k] != before.get(k, 0)}
    assert delta == {"attention_block": depth, "gemm": 2 * depth}
    assert tgemm.core_launches()["gemm"] == 4 * depth
    assert (got - fused).abs().max().item() <= 5e-2
