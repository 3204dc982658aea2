"""The port's int8 paths against the JAX package's, on the same trees and
numpy-seeded inputs (Pallas kernels in interpret mode):

- the int8 lowlat stream (kernel 10's int8 branch): the packs of
  ``ops/lowlat.py::pack_encoder_weights(weight_dtype=int8)``, the plain
  kernels on them, and ``serving_forward_lowlat`` on
  ``prepare_lowlat(int8_weights=True)``;
- the int8 module path (``models/serving.py``): ``quantize_dense``,
  ``dense_int8``, ``quantize_vit_params`` and ``vit_antispoof_int8_apply``
  (its attention core is kernel 9's plain version here).

Tolerances:
- packs and ``quantize_dense``: exact (the same f32 maxima, divisions and
  round-half-to-even in both);
- plain kernels on the int8 pack, f32: 1e-5 of the output's largest
  magnitude (f32 sums in another order); bf16: 2 bf16 ulps of it (as
  tests/test_torch_lowlat.py, one rounding may land an ulp apart);
- ``serving_forward_lowlat`` scores: f32 1e-5 absolute (P(live) <= 1);
  bf16 5e-3 (BF16_SCORE_ATOL of tests/test_torch_fastserve.py: bf16
  streams two layers deep);
- ``dense_int8``: 1e-6 of the output's magnitude (the int32 sums are
  exact in both; two f32 multiplies and the bias add round the same);
- ``vit_antispoof_int8_apply`` against JAX's ``interpret=True``: 1e-4 of
  the logits' magnitude (measured 0 to 1e-6 at f32; only a flipped
  ``round(x / s)`` of one activation could move it further).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import fastserve as jfast
from vit_spoof_detection_pda_tpu.models import serving as jserv
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.ops import lowlat as jlow
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast
from vit_spoof_detection_pda_tpu_torch.models import serving as tserv
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.ops import lowlat as tlow

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
F32_REL = 1e-5
SCORE_F32_ATOL = 1e-5
BF16_SCORE_ATOL = 5e-3
DENSE_REL = 1e-6
APPLY_REL = 1e-4


def _geometry(name):
    """tests/test_torch_lowlat.py's geometries: ``small`` (no fold-ends)
    and ``foldable`` (patch_dim 48 == D)."""
    if name == "small":
        m = jvit.ViTAntiSpoof(patch_size=16, embed_dim=64, depth=2,
                              num_heads=2, hidden=16, gelu="tanh")
        img = 32
    else:
        m = jvit.ViTAntiSpoof(patch_size=4, embed_dim=48, depth=2,
                              num_heads=2, hidden=16, gelu="tanh")
        img = 8
    variables = m.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))
    folded = jvit.fold_normalization(variables)
    return dict(folded=folded, np=jax.tree.map(np.asarray, folded["params"]),
                patch=m.patch_size, img=img, d=m.embed_dim)


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
    tol = (F32_REL * float(np.abs(want).max()) if dtype == torch.float32
           else _ulp_tol(want))
    assert np.abs(got - want).max() <= tol


def _int8_packs(g, depth, jdt, tdt):
    j = jlow.pack_encoder_weights(g["folded"]["params"]["vit"], depth=depth,
                                  dtype=jdt, weight_dtype=jnp.int8)
    t = tlow.pack_encoder_weights(g["np"]["vit"], depth=depth, dtype=tdt,
                                  weight_dtype=torch.int8)
    return j, t


# --------------------------------------------------------------------------
# the int8 lowlat stream
# --------------------------------------------------------------------------


@pytest.mark.parametrize("geom", ["small", "foldable"])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_int8_pack_equals_jax(request, geom, jdt, tdt):
    g = request.getfixturevalue(geom)
    (jw, js), (tw, ts) = _int8_packs(g, 2, jdt, tdt)
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == js.shape == (6, 5, 4 * g["d"])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_int8_encoder_plain_matches_jax(small, b, jdt, tdt):
    depth = 2 if tdt == torch.float32 else 1
    (jw, js), (tw, ts) = _int8_packs(small, depth, jdt, tdt)
    x = np.random.default_rng(60 + b).standard_normal((b, 8, 64)).astype(
        np.float32)
    want = jlow.encoder_forward_lowlat(jnp.asarray(x, jdt), jw, js,
                                       num_heads=2, valid_len=5,
                                       interpret=True)
    got = tlow.encoder_forward_lowlat(torch.tensor(x).to(tdt), tw, ts,
                                      num_heads=2, valid_len=5)
    assert got.dtype == tdt
    _assert_kernel_close(got, want, tdt)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_int8_fold_ends_plain_matches_jax(foldable, jdt, tdt):
    depth = 2 if tdt == torch.float32 else 1
    (jw, js), (tw, ts) = _int8_packs(foldable, depth, jdt, tdt)
    jends = jlow.pack_end_weights(foldable["folded"]["params"], dtype=jdt)
    tends = tlow.pack_end_weights(foldable["np"], dtype=tdt)
    x = np.random.default_rng(5).standard_normal((1, 8, 48)).astype(
        np.float32)
    x[:, 0] = 0
    x[:, 5:] = 0
    want = jlow.forward_lowlat_e2e(jnp.asarray(x, jdt), jw, js, *jends,
                                   num_heads=2, valid_len=5, interpret=True)
    got = tlow.forward_lowlat_e2e(torch.tensor(x).to(tdt), tw, ts, *tends,
                                  num_heads=2, valid_len=5)
    assert got.shape == (1, 2)
    _assert_kernel_close(got, want, tdt)


@pytest.mark.parametrize("geom", ["small", "foldable"])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_int8_serving_forward_lowlat_matches_jax(request, geom, jdt, tdt):
    """fold-ends (``foldable``) and encoder-only (``small``)."""
    g = request.getfixturevalue(geom)
    u8 = np.random.default_rng(9).integers(0, 256, (1, g["img"], g["img"], 3),
                                           dtype=np.uint8)
    jprep = jfast.prepare_lowlat(g["folded"]["params"], depth=2, dtype=jdt,
                                 int8_weights=True)
    tprep = tfast.prepare_lowlat(g["np"], depth=2, dtype=tdt,
                                 int8_weights=True, device="cpu")
    assert ("aux" in tprep) == (geom == "foldable")
    kw = dict(num_heads=2, patch_size=g["patch"])
    want = jfast.serving_forward_lowlat(jprep, jnp.asarray(u8), dtype=jdt,
                                        interpret=True, **kw)
    got = tfast.serving_forward_lowlat(tprep, u8, dtype=tdt, device="cpu",
                                       **kw)
    atol = SCORE_F32_ATOL if tdt == torch.float32 else BF16_SCORE_ATOL
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def test_int8_encoder_refuses_a_mismatched_pack(small):
    """The CUDA wrapper's argument checks (run before any launch): an int8
    W needs its 5-row S, a bf16 W the 4-row one."""
    (_j, (tw, ts)) = _int8_packs(small, 1, jnp.float32, torch.bfloat16)
    x = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="s_packed"):
        tlow._check_encoder_args(x, tw, ts[:, :4].contiguous(), 2, 5)
    with pytest.raises(ValueError, match="s_packed"):
        tlow._check_encoder_args(x, tw.to(torch.bfloat16), ts, 2, 5)
    assert tlow._check_encoder_args(x, tw, ts, 2, 5) == (1, 8, 64, 1)


# --------------------------------------------------------------------------
# the int8 module path
# --------------------------------------------------------------------------


def test_quantize_dense_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    w[:, 3] = 0.0                                     # the 1e-8 floor
    b = rng.standard_normal(32).astype(np.float32)
    want = jserv.quantize_dense(w, b)
    got = tserv.quantize_dense(w, b, device="cpu")
    assert got["q"].dtype == torch.int8
    for k in ("q", "scale", "bias"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_dense_int8_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((128, 64)).astype(np.float32) * 0.05
    b = rng.standard_normal(64).astype(np.float32) * 0.01
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    want = np.asarray(jserv.dense_int8(jnp.asarray(x),
                                       jserv.quantize_dense(w, b)))
    got = tserv.dense_int8(torch.from_numpy(x),
                           tserv.quantize_dense(w, b, device="cpu"))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 64)
    assert (np.abs(got.numpy() - want).max()
            <= DENSE_REL * np.abs(want).max())
    # the JAX test's own bound against the float product
    ref = x @ w + b
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).std() < 0.08


@pytest.fixture(scope="module")
def int8_model():
    """tests/test_serving.py's model: patch 8, D 64, depth 2, 2 heads."""
    module = jvit.ViTAntiSpoof(patch_size=8, embed_dim=64, depth=2,
                               num_heads=2, hidden=32)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    x = np.random.default_rng(2).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    return module, variables, x


def test_quantize_vit_params_equals_jax(int8_model):
    _m, variables, _x = int8_model
    want = jserv.quantize_vit_params(variables["params"], depth=2)
    got = tserv.quantize_vit_params(
        jax.tree.map(np.asarray, variables["params"]), depth=2, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(w))


def test_int8_apply_matches_jax_interpret(int8_model):
    module, variables, x = int8_model
    qp = jserv.quantize_vit_params(variables["params"], depth=2)
    want = np.asarray(jserv.vit_antispoof_int8_apply(
        qp, jnp.asarray(x), num_heads=2, patch_size=8, interpret=True))
    tqp = tserv.quantize_vit_params(
        jax.tree.map(np.asarray, variables["params"]), depth=2, device="cpu")
    got = tserv.vit_antispoof_int8_apply(tqp, torch.from_numpy(x),
                                         num_heads=2, patch_size=8)
    assert got.dtype == torch.float32 and got.shape == (4, 2)
    assert (np.abs(got.numpy() - want).max()
            <= APPLY_REL * np.abs(want).max())


def test_int8_apply_close_to_float_forward(int8_model):
    """The JAX test's own criterion (tests/test_serving.py:51-57) against
    the port's f32 module forward."""
    module, variables, x = int8_model
    tm = tvit.ViTAntiSpoof(patch_size=8, embed_dim=64, depth=2, num_heads=2,
                           hidden=32, img_size=32).eval()
    tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    qp = tserv.quantize_vit_params(
        jax.tree.map(np.asarray, variables["params"]), depth=2, device="cpu")
    got = tserv.vit_antispoof_int8_apply(qp, torch.from_numpy(x),
                                         num_heads=2, patch_size=8).numpy()
    denom = max(np.abs(want).std(), 1e-3)
    assert np.abs(got - want).max() / denom < 0.35
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75
