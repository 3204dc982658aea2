"""The port's whole-encoder serving path (ops/lowlat.py and the lowlat /
batch-grid regimes of models/fastserve.py) against the JAX package's
(Pallas kernels in interpret mode), on the same folded weights, streams
and uint8 images made from numpy seeds.

Tolerances:
- packs: exact (plain layout work and the same round-to-nearest casts);
- plain kernels at f32: atol 1e-5 (sums in another f32 order, outputs
  of magnitude up to about 6);
- plain kernels at bf16, depth 1: 2 bf16 ulps of the largest output
  magnitude (the two sides round the same intermediates, but a rounding
  can land one ulp apart after a different f32 summation order);
- scores at f32: atol 2e-4 / rtol 1e-4 (tests/test_fastserve.py's bound);
  at bf16: 5e-3 (BF16_SCORE_ATOL of tests/test_torch_fastserve.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import fastserve as jfast
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.ops import lowlat as jlow
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast
from vit_spoof_detection_pda_tpu_torch.ops import lowlat as tlow

F32_ATOL = 1e-5
SCORE_ATOL, SCORE_RTOL = 2e-4, 1e-4
BF16_SCORE_ATOL = 5e-3
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]


def _geometry(name, depth=2):
    """tests/test_lowlat.py's two geometries: ``small`` (patch_dim 768 !=
    D 64, so no fold-ends) and ``foldable`` (patch_dim 48 == D)."""
    if name == "small":
        m = jvit.ViTAntiSpoof(patch_size=16, embed_dim=64, depth=depth,
                              num_heads=2, hidden=16, gelu="tanh")
        img = 32
    else:
        m = jvit.ViTAntiSpoof(patch_size=4, embed_dim=48, depth=depth,
                              num_heads=2, hidden=16, gelu="tanh")
        img = 8
    variables = m.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))
    folded = jvit.fold_normalization(variables)
    return dict(folded=folded, np=jax.tree.map(np.asarray, folded["params"]),
                patch=m.patch_size, img=img, depth=depth, d=m.embed_dim)


@pytest.fixture(scope="module")
def small():
    return _geometry("small")


@pytest.fixture(scope="module")
def foldable():
    return _geometry("foldable")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _ulp_tol(want, ulps=2):
    amax = float(np.abs(want).max())
    return ulps * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _assert_kernel_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert np.abs(got - want).max() <= _ulp_tol(want)


def _stream(seed, b, tp, d, dtype):
    x = np.random.default_rng(seed).standard_normal((b, tp, d)).astype(
        np.float32)
    return x, jnp.asarray(x, dtype)


def _images(seed, b, img):
    return np.random.default_rng(seed).integers(0, 256, (b, img, img, 3),
                                                dtype=np.uint8)


# --------------------------------------------------------------------------
# packs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("geom", ["small", "foldable"])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_pack_encoder_weights_equals_jax(request, geom, jdt, tdt):
    g = request.getfixturevalue(geom)
    vit = g["folded"]["params"]["vit"]
    for jfn, tfn in ((jlow.pack_encoder_weights, tlow.pack_encoder_weights),
                     (jlow.pack_encoder_weights_batchgrid,
                      tlow.pack_encoder_weights_batchgrid)):
        jw, js = jfn(vit, depth=2, dtype=jdt)
        tw, ts = tfn(g["np"]["vit"], depth=2, dtype=tdt)
        assert tw.dtype == tdt and ts.dtype == torch.float32
        assert tw.shape == jw.shape and ts.shape == js.shape
        np.testing.assert_array_equal(_np(tw), _np(jw))
        np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_pack_end_weights_equals_jax(foldable, jdt, tdt):
    want = jlow.pack_end_weights(foldable["folded"]["params"], dtype=jdt)
    got = tlow.pack_end_weights(foldable["np"], dtype=tdt)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert got[0].dtype == tdt
    for t, w in zip(got, want):
        np.testing.assert_array_equal(_np(t), _np(w))


def test_packs_reject_what_the_layout_cannot_hold(small):
    vit = dict(small["np"]["vit"])
    blk = dict(vit["block0"])
    blk["mlp"] = {"fc1": {"kernel": np.zeros((64, 128), np.float32),
                          "bias": np.zeros(128, np.float32)},
                  "fc2": blk["mlp"]["fc2"]}
    vit["block0"] = blk
    with pytest.raises(ValueError, match="4\\*embed"):
        tlow.pack_encoder_weights(vit, depth=2)
    with pytest.raises(ValueError, match="patch_dim"):
        tlow.pack_end_weights(small["np"])
    with pytest.raises(ValueError, match="anti-spoof head"):
        tlow.pack_end_weights({"vit": small["np"]["vit"]})


# --------------------------------------------------------------------------
# plain kernels vs the Pallas kernels in interpret mode
# --------------------------------------------------------------------------


def _packs(g, depth, jdt, tdt, batch_grid=False):
    vit = g["folded"]["params"]["vit"]
    jfn, tfn = ((jlow.pack_encoder_weights_batchgrid,
                 tlow.pack_encoder_weights_batchgrid) if batch_grid else
                (jlow.pack_encoder_weights, tlow.pack_encoder_weights))
    return jfn(vit, depth=depth, dtype=jdt), tfn(g["np"]["vit"], depth=depth,
                                                 dtype=tdt)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_encoder_plain_matches_jax(small, b, jdt, tdt):
    depth = 2 if tdt == torch.float32 else 1
    (jw, js), (tw, ts) = _packs(small, depth, jdt, tdt)
    x, xj = _stream(30 + b, b, 8, 64, jdt)
    want = jlow.encoder_forward_lowlat(xj, jw, js, num_heads=2, valid_len=5,
                                       interpret=True)
    got = tlow.encoder_forward_lowlat(torch.tensor(x).to(tdt), tw, ts,
                                      num_heads=2, valid_len=5)
    assert got.dtype == tdt
    _assert_kernel_close(got, want, tdt)


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_batchgrid_plain_matches_jax(small, b, jdt, tdt):
    depth = 2 if tdt == torch.float32 else 1
    (jw, js), (tw, ts) = _packs(small, depth, jdt, tdt, batch_grid=True)
    x, xj = _stream(40 + b, b, 8, 64, jdt)
    want = jlow.encoder_forward_lowlat_batchgrid(xj, jw, js, num_heads=2,
                                                 valid_len=5, interpret=True)
    got = tlow.encoder_forward_lowlat_batchgrid(
        torch.tensor(x).to(tdt), tw, ts, num_heads=2, valid_len=5)
    _assert_kernel_close(got, want, tdt)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_fold_ends_plain_matches_jax(foldable, b, jdt, tdt):
    depth = 2 if tdt == torch.float32 else 1
    (jw, js), (tw, ts) = _packs(foldable, depth, jdt, tdt)
    jends = jlow.pack_end_weights(foldable["folded"]["params"], dtype=jdt)
    tends = tlow.pack_end_weights(foldable["np"], dtype=tdt)
    x, _ = _stream(50 + b, b, 8, 48, jdt)
    x[:, 0] = 0                         # the CLS slot
    x[:, 5:] = 0                        # padding rows
    want = jlow.forward_lowlat_e2e(jnp.asarray(x, jdt), jw, js, *jends,
                                   num_heads=2, valid_len=5, interpret=True)
    got = tlow.forward_lowlat_e2e(torch.tensor(x).to(tdt), tw, ts, *tends,
                                  num_heads=2, valid_len=5)
    assert got.dtype == torch.float32 and got.shape == (b, 2)
    _assert_kernel_close(got, want, tdt)


def test_plain_versions_count_no_launch(small):
    (_j, (tw, ts)) = _packs(small, 1, jnp.float32, torch.bfloat16)
    before = dict(tlow.LAUNCHES)
    x = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    tlow.encoder_forward_lowlat(x, tw, ts, num_heads=2, valid_len=5)
    assert tlow.LAUNCHES == before


# --------------------------------------------------------------------------
# serving regimes
# --------------------------------------------------------------------------


def _score_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=SCORE_ATOL,
                                   rtol=SCORE_RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("geom", ["small", "foldable"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_serving_forward_lowlat_matches_jax(request, geom, b, jdt, tdt):
    g = request.getfixturevalue(geom)
    u8 = _images(70 + b, b, g["img"])
    jprep = jfast.prepare_lowlat(g["folded"]["params"], depth=2, dtype=jdt)
    tprep = tfast.prepare_lowlat(g["np"], depth=2, dtype=tdt, device="cpu")
    assert ("aux" in tprep) == ("aux" in jprep) == (geom == "foldable")
    kw = dict(num_heads=2, patch_size=g["patch"])
    want = jfast.serving_forward_lowlat(jprep, jnp.asarray(u8), dtype=jdt,
                                        interpret=True, **kw)
    got = tfast.serving_forward_lowlat(tprep, u8, dtype=tdt, device="cpu",
                                       **kw)
    _score_close(got, want, tdt)


@pytest.mark.parametrize("b", [2, 3, 5])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_serving_forward_lowlat_batch_matches_jax(small, b, jdt, tdt):
    u8 = _images(80 + b, b, small["img"])
    jprep = jfast.prepare_lowlat(small["folded"]["params"], depth=2,
                                 dtype=jdt, batch_grid=True, per_item=False)
    tprep = tfast.prepare_lowlat(small["np"], depth=2, dtype=tdt,
                                 batch_grid=True, per_item=False,
                                 device="cpu")
    assert "bg_w" in tprep and "packed_w" not in tprep
    want = jfast.serving_forward_lowlat_batch(
        jprep, jnp.asarray(u8), num_heads=2, dtype=jdt, chunk_size=2,
        interpret=True)
    got = tfast.serving_forward_lowlat_batch(tprep, u8, num_heads=2,
                                             dtype=tdt, chunk_size=2,
                                             device="cpu")
    assert got.shape == (b,)
    _score_close(got, want, tdt)


def test_prepare_lowlat_pack_selection(small, foldable):
    p = tfast.prepare_lowlat(small["np"], depth=2, device="cpu")
    assert "aux" not in p and p["packed_w"].shape == (6, 64, 256)
    p = tfast.prepare_lowlat(foldable["np"], depth=2, batch_grid=True,
                             device="cpu")
    assert {"packed_w", "bg_w", "end_w", "aux"} <= set(p)
    assert p["params"]["vit"]["block0"]["mlp"]["fc1"]["kernel"].dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="nothing would be packed"):
        tfast.prepare_lowlat(small["np"], depth=2, per_item=False,
                             device="cpu")


# --------------------------------------------------------------------------
# error paths
# --------------------------------------------------------------------------


def test_lowlat_rejects_wrong_image_size(foldable):
    prep = tfast.prepare_lowlat(foldable["np"], depth=2, device="cpu")
    with pytest.raises(ValueError, match="tokens"):
        tfast.serving_forward_lowlat(prep, np.zeros((1, 4, 4, 3), np.uint8),
                                     num_heads=2, patch_size=4,
                                     device="cpu")


def test_batchgrid_takes_at_most_four_items(small):
    (_j, (w, s)) = _packs(small, 1, jnp.float32, torch.float32,
                          batch_grid=True)
    with pytest.raises(ValueError, match="<= 4"):
        tlow.encoder_forward_lowlat_batchgrid(torch.zeros((5, 8, 64)), w, s,
                                              num_heads=2, valid_len=5)
    with pytest.raises(ValueError, match="full-precision"):
        tlow.encoder_forward_lowlat_batchgrid(
            torch.zeros((2, 8, 64)), w.to(torch.int8), s, num_heads=2,
            valid_len=5)


def test_int8_requests_name_the_roadmap_item(small):
    with pytest.raises(NotImplementedError, match="Queue 2 item 17"):
        tlow.pack_encoder_weights(small["np"]["vit"], depth=2,
                                  weight_dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 or None"):
        tlow.pack_encoder_weights(small["np"]["vit"], depth=2,
                                  weight_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="Queue 2 item 17"):
        tfast.prepare_lowlat(small["np"], depth=2, int8_weights=True,
                             device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 2 item 17"):
        tlow.encoder_forward_lowlat(
            torch.zeros((1, 8, 64)),
            torch.zeros((6, 64, 256), dtype=torch.int8),
            torch.zeros((6, 5, 256)), num_heads=2, valid_len=5)
    # the JAX package's own refusals, kept
    with pytest.raises(ValueError, match="int8_weights"):
        tfast.prepare_lowlat(small["np"], depth=2, per_item=False,
                             batch_grid=True, int8_weights=True,
                             device="cpu")
