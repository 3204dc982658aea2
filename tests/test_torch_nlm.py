"""The port's fast NLM (ops/nlm.py, kernel 16's plain version) and eval
preprocessing (ops/image.py) against the JAX package's.

Tolerances, beside their reasons:
- plain NLM vs JAX's XLA form (``use_pallas=False``): 1e-5 at f32 (the
  port sums each patch directly, JAX takes differences of cumulative
  sums; the weights' exponent multiplies the distance by 1 / h^2 = 100);
- vs JAX's Pallas kernel in interpret mode: 1e-4, that test's own bound
  (its shifts are one-hot matmuls);
- ``resize_bilinear`` and ``preprocess_eval`` vs JAX: 1e-5 (the same
  weight matrices; the two products in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.ops import image as JI
from vit_spoof_detection_pda_tpu.ops.nlm import fast_nlm_denoise as j_nlm
from vit_spoof_detection_pda_tpu.ops.nlm_pallas import nlm_denoise_pallas
from vit_spoof_detection_pda_tpu_torch.ops import image as TI
from vit_spoof_detection_pda_tpu_torch.ops import nlm as TN


def _imgs(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape,kw", [
    ((2, 16, 16, 3), {}),                                   # the defaults
    ((1, 12, 14, 3), dict(h=0.2, sigma=0.05, search_radius=2)),
    ((2, 9, 20, 1), dict(search_radius=3, patch_radius=2)),
])
def test_nlm_plain_matches_jax_xla(shape, kw):
    img = _imgs(0, shape)
    want = np.asarray(j_nlm(jnp.asarray(img), use_pallas=False, **kw))
    got = TN.fast_nlm_denoise(torch.tensor(img), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_nlm_plain_matches_jax_pallas_interpret():
    img = _imgs(1, (2, 16, 16, 3))
    kw = dict(h=0.2, sigma=0.05, search_radius=2, patch_radius=1)
    want = np.asarray(nlm_denoise_pallas(jnp.asarray(img), interpret=True,
                                         **kw))
    got = TN.nlm_denoise_plain(torch.tensor(img), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_nlm_hwc_and_denoises():
    rng = np.random.default_rng(2)
    clean = np.zeros((32, 32, 3), np.float32)
    clean[16:] = 0.75
    clean[:16] = 0.25
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1
                    ).astype(np.float32)
    den = TN.fast_nlm_denoise(torch.tensor(noisy), h=0.15, sigma=0.08)
    assert den.shape == (32, 32, 3)
    assert ((den.numpy() - clean) ** 2).mean() < 0.35 * (
        (noisy - clean) ** 2).mean()


@pytest.mark.parametrize("src,dst", [((32, 32), (16, 16)), ((20, 30), (24, 12)),
                                     ((17, 17), (17, 40)), ((8, 8), (8, 8))])
def test_resize_bilinear_matches_jax(src, dst):
    x = _imgs(3, (2, *src, 3))
    want = np.asarray(JI.resize_bilinear(jnp.asarray(x), dst))
    got = TI.resize_bilinear(torch.tensor(x), dst)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    hwc = TI.resize_bilinear(torch.tensor(x[0]), dst)
    np.testing.assert_allclose(hwc.numpy(), want[0], atol=1e-5, rtol=0)


def test_resize_shorter_side_and_center_crop_match_jax():
    x = _imgs(4, (1, 30, 45, 3))
    want = np.asarray(JI.resize_shorter_side(jnp.asarray(x), 16))
    got = TI.resize_shorter_side(torch.tensor(x), 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        TI.center_crop(got, 16).numpy(),
        np.asarray(JI.center_crop(jnp.asarray(got.numpy()), 16)))
    with pytest.raises(ValueError, match="exceeds"):
        TI.center_crop(got, 17)


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("src,size", [((24, 24), 16), ((16, 16), 16)])
def test_preprocess_eval_matches_jax(denoise, src, size):
    u8 = np.random.default_rng(5).integers(0, 256, (2, *src, 3),
                                           dtype=np.uint8)
    want = np.asarray(JI.preprocess_eval(jnp.asarray(u8), size=size,
                                         denoise=denoise))
    got = TI.preprocess_eval(u8, size=size, denoise=denoise, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_image_helpers_match_jax():
    x = _imgs(6, (2, 4, 4, 3)) * 1.2 - 0.1
    np.testing.assert_array_equal(
        TI.to_uint8(torch.tensor(x)).numpy(),
        np.asarray(JI.to_uint8(jnp.asarray(x))))
    np.testing.assert_allclose(
        TI.denormalize(torch.tensor(x)).numpy(),
        np.asarray(JI.denormalize(jnp.asarray(x))), atol=1e-7)


def test_preprocess_eval_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TI.preprocess_eval(np.zeros((1, 8, 8, 3), np.uint8), size=8)
