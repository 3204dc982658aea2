"""The port's serving path (models/fastserve.py) against the JAX
package's ``serving_forward`` (Pallas kernels in interpret mode) and the
flax module, on the same folded weights and uint8 images.

f32 at atol 2e-4 / rtol 1e-4 (tests/test_fastserve.py's bound).  bf16:
the two sides round the same intermediates to bf16, so most scores agree
bit for bit; but they sum in different f32 orders, so now and then a
rounding in the stream lands one ulp apart.  At this width that moved a
score by at most 2.5e-3 over 192 images (3 inits x 64), about half the
model's own bf16-vs-f32 drift (up to 5.7e-3), hence atol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import fastserve as jfast
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt

GEOM = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)
IMG = 32
BF16_SCORE_ATOL = 5e-3


@pytest.fixture(scope="module")
def model():
    jm = jvit.ViTAntiSpoof(**GEOM, gelu="tanh")
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    tm = tvit.ViTAntiSpoof(**GEOM, gelu="tanh", img_size=IMG).eval()
    tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    folded = jvit.fold_normalization(variables)
    return jm, variables, folded, tm


def _images(seed, b):
    return np.random.default_rng(seed).integers(
        0, 256, (b, IMG, IMG, 3), dtype=np.uint8)


def _port(folded, u8, dtype):
    return tfast.serving_forward(
        jax.tree.map(np.asarray, folded["params"]), u8, num_heads=2,
        depth=2, dtype=dtype, device="cpu").numpy()


def _jax(folded, u8, dtype):
    return np.asarray(jfast.serving_forward(
        folded["params"], jnp.asarray(u8), num_heads=2, depth=2,
        dtype=dtype, interpret=True), np.float32)


@pytest.mark.parametrize("b", [4, 3])
def test_serving_forward_matches_jax_f32(model, b):
    _jm, _v, folded, _tm = model
    u8 = _images(b, b)
    np.testing.assert_allclose(_port(folded, u8, torch.float32),
                               _jax(folded, u8, jnp.float32),
                               atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("b", [4, 3])
def test_serving_forward_matches_jax_bf16(model, b):
    _jm, _v, folded, _tm = model
    u8 = _images(10 + b, b)
    got = _port(folded, u8, torch.bfloat16)
    want = _jax(folded, u8, jnp.bfloat16)
    assert got.dtype == np.float32 and got.shape == (b,)
    np.testing.assert_allclose(got, want, atol=BF16_SCORE_ATOL, rtol=0)
    assert (got == want).mean() >= 0.5      # same rounding points


def test_serving_forward_matches_flax_module(model):
    """Folded weights on raw pixels == the module on normalized input."""
    jm, _v, folded, _tm = model
    u8 = _images(20, 4)
    logits = jm.apply(folded, jnp.asarray(u8, jnp.float32))
    want = np.asarray(jax.nn.sigmoid(logits[:, 1] - logits[:, 0]))
    np.testing.assert_allclose(_port(folded, u8, torch.float32), want,
                               atol=2e-4, rtol=1e-4)


def test_make_serving_fn_matches_direct_forward(model):
    _jm, _v, folded, tm = model
    u8 = _images(21, 32)
    fn = tfast.make_serving_fn(tm, batch_size=32, device="cpu")
    got = fn(u8)
    assert got.dtype == torch.float32 and got.shape == (32,)
    want = _port(folded, u8, torch.bfloat16)
    # the same function on the same bf16-cast weights: only the fold
    # (numpy vs flax f32 dot) differs
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_SCORE_ATOL)
    np.testing.assert_allclose(got.numpy(), _jax(folded, u8, jnp.bfloat16),
                               atol=BF16_SCORE_ATOL)


def test_serving_program_prepares_kernel_dtypes_once(model):
    _jm, _v, _f, tm = model
    weights, raw, kw = tfast.serving_program(tm, mode="fastserve",
                                             device="cpu")
    assert raw is tfast.serving_forward
    assert kw == dict(num_heads=2, patch_size=16, depth=2, norm_eps=1e-6,
                      dtype=torch.bfloat16, device=torch.device("cpu"))
    blk = weights["vit"]["block0"]
    assert blk["attn"]["qkv"]["kernel"].dtype == torch.bfloat16
    assert blk["attn"]["qkv"]["kernel"].shape == (64, 192)   # [in, out]
    assert blk["mlp"]["fc2"]["kernel"].dtype == torch.bfloat16
    assert blk["norm1"]["scale"].dtype == torch.float32
    assert blk["attn"]["qkv"]["bias"].dtype == torch.float32
    assert weights["vit"]["pos_embed"].dtype == torch.bfloat16
    assert weights["head"]["fc1"]["bias"].dtype == torch.float32
    # casts inside the forward are then no-ops on the prepared tensors
    k = blk["attn"]["qkv"]["kernel"]
    assert tfast._t(k, torch.bfloat16, torch.device("cpu")) is k


def test_serving_forward_counts_no_kernel_launch_on_cpu(model):
    _jm, _v, folded, _tm = model
    before = dict(tatt.LAUNCHES)
    _port(folded, _images(22, 2), torch.bfloat16)
    assert tatt.LAUNCHES == before


def test_make_serving_fn_needs_a_card_unless_cpu_is_asked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present on this machine")
    _jm, _v, _f, tm = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfast.make_serving_fn(tm, batch_size=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfast.serving_forward({}, _images(0, 1))


@pytest.mark.parametrize("mode,b", [("lowlat", 32), ("batch_grid", 32),
                                    ("auto", 1), ("auto", 16)])
def test_small_batch_regimes_match_jax(model, mode, b):
    """The lowlat and batch-grid regimes (also forced at B = 32) against
    JAX ``make_serving_fn(..., interpret=True)`` on the same weights; with
    ``mode="auto"`` the port's regime for B (the H100's table: lowlat at
    B = 1, fastserve at B = 16) against the same regime in JAX."""
    jm, variables, _f, tm = model
    u8 = _images(30 + b, b)
    regime = tfast.auto_serving_mode(b) if mode == "auto" else mode
    got = tfast.make_serving_fn(tm, batch_size=b, mode=mode,
                                device="cpu")(u8)
    want = jfast.make_serving_fn(jm, variables, batch_size=b, mode=regime,
                                 interpret=True)(jnp.asarray(u8))
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=BF16_SCORE_ATOL, rtol=0)
    _w, raw, _kw = tfast.serving_program(tm, mode=regime, device="cpu")
    assert raw is {"lowlat": tfast.serving_forward_lowlat,
                   "batch_grid": tfast.serving_forward_lowlat_batch,
                   "fastserve": tfast.serving_forward}[regime]


def test_serving_modes_are_validated(model):
    _jm, _v, _f, tm = model
    with pytest.raises(ValueError, match="unknown serving mode"):
        tfast.serving_program(tm, mode="turbo", device="cpu")
    with pytest.raises(TypeError, match="anti-spoof head"):
        tfast.serving_program(torch.nn.Linear(2, 2), mode="fastserve",
                              device="cpu")
    with pytest.raises(ValueError, match="int8_weights"):
        tfast.serving_program(tm, mode="batch_grid", int8_weights=True,
                              device="cpu")
    # the int8 stream is ported: the B = 1 regime takes it
    fn = tfast.make_serving_fn(tm, batch_size=1, int8_weights=True,
                               device="cpu")
    score = fn(_images(3, 1))
    assert score.shape == (1,) and torch.isfinite(score).all()


def test_auto_serving_mode_matches_jax():
    """The regime table, pinned: the port's follows the H100's
    measurements (``chip_smoke.py`` ``times_small``: fastserve beats
    batch-grid at every B = 2-16 there), so it matches JAX's TPU table at
    B = 1 (lowlat) and B >= 17 (fastserve) and differs at B = 2-16, where
    JAX serves batch-grid."""
    for b in (1, 17, 32, 128, 1024):
        assert tfast.auto_serving_mode(b) == jfast.auto_serving_mode(b)
    for b in (2, 4, 8, 16):
        assert jfast.auto_serving_mode(b) == "batch_grid"
        assert tfast.auto_serving_mode(b) == "fastserve"
    assert tfast.auto_serving_mode(1) == "lowlat"
    with pytest.raises(ValueError):
        tfast.auto_serving_mode(0)


def test_embed_patches_matches_jax_bf16(model):
    """The stem alone: bf16 pixels, f32 GEMM of bf16-rounded operands, one
    rounding, bf16 cls and pos embed.  Within one bf16 ulp, since the
    f32 GEMM may sum in another order than XLA's."""
    _jm, _v, folded, _tm = model
    u8 = _images(23, 3)
    vit = folded["params"]["vit"]
    want = jfast.embed_patches(vit, jnp.asarray(u8), dtype=jnp.bfloat16,
                               patch_size=16)
    got = tfast.embed_patches(jax.tree.map(np.asarray, vit),
                              torch.tensor(u8), dtype=torch.bfloat16,
                              patch_size=16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2.0 ** -6, rtol=2.0 ** -7)


def test_cls_head_matches_jax(model):
    """Final LN + anti-spoof head on a bf16 stream (f32 fc1 of the
    bf16-rounded kernel, erf GELU, bf16 fc2)."""
    _jm, _v, folded, _tm = model
    rng = np.random.default_rng(24)
    x = rng.standard_normal((5, 8, 64)).astype(np.float32)
    want = np.asarray(jfast._cls_head_scores(
        folded["params"], jnp.asarray(x, jnp.bfloat16), norm_eps=1e-6,
        dtype=jnp.bfloat16), np.float32)
    got = tfast._cls_head_scores(
        jax.tree.map(np.asarray, folded["params"]),
        torch.tensor(x, dtype=torch.bfloat16), norm_eps=1e-6,
        dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
