"""The port's scanline warp (ops/warp.py, kernel 15's plain version and the
tower's warps) against the JAX package, on numpy-seeded inputs.

Tolerances, beside their reasons:
- ``warp_pass_plain`` vs the JAX Pallas kernel in interpret mode: atol
  1e-6 at f32 (the pin of tests/test_warp_pallas.py; both compute the
  same tent sum in f32, the interpret-mode sum adding zeros in another
  association), and at bf16 at most one bf16 ulp of the output;
- vs the XLA roll form ``_resample_rows_field``: atol 1e-6 at f32 (its
  weights are ``1 - frac`` and ``frac``, the tent's can round one f32 ulp
  apart);
- rotate_3shear, perspective_warp_2pass and displacement_warp_2pass vs
  JAX's at f32 on the same angle, homography and fields: 1e-5 (three
  chained passes; ``tan``/``sin`` of the two libraries may differ by an
  ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.ops import warp as JW
from vit_spoof_detection_pda_tpu.ops.warp_pallas import (
    resample_cols_field_pallas, resample_rows_field_pallas)
from vit_spoof_detection_pda_tpu_torch.ops import warp as TW


def _img(seed, b=2, h=32, w=32, c=3):
    return np.random.default_rng(seed).random((b, h, w, c)).astype(np.float32)


def _field(seed, b, h, w, lim):
    rng = np.random.default_rng(seed)
    return ((rng.random((b, h, w)) * 2 - 1) * lim).astype(np.float32)


def _pallas(img, field, kmax, along_y):
    fn = resample_cols_field_pallas if along_y else resample_rows_field_pallas
    return np.stack([np.asarray(fn(jnp.asarray(img[i]), jnp.asarray(field[i]),
                                   kmax, interpret=True).astype(jnp.float32))
                     for i in range(img.shape[0])])


def _port(img, field, kmax, along_y, dtype=torch.float32):
    return TW.warp_pass(torch.tensor(img).to(dtype), torch.tensor(field),
                        kmax, along_y=along_y)


@pytest.mark.parametrize("along_y", [False, True])
@pytest.mark.parametrize("h,w,kmax,lim", [
    (32, 32, 4, 3.5),
    (32, 32, 8, 7.9),
    (31, 29, 4, 3.0),          # odd height and width (the TPU padded to 16)
    (16, 16, 12, 9.0),         # many pixels out of frame
])
def test_warp_pass_plain_matches_pallas_f32(along_y, h, w, kmax, lim):
    img = _img(1, 2, h, w)
    field = _field(2, 2, h, w, lim)
    want = _pallas(img, field, kmax, along_y)
    got = _port(img, field, kmax, along_y).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("along_y", [False, True])
def test_warp_pass_plain_matches_pallas_bf16(along_y):
    img = _img(3).astype(jnp.bfloat16)
    field = _field(4, 2, 32, 32, 3.0)
    fn = resample_cols_field_pallas if along_y else resample_rows_field_pallas
    want = np.stack([np.asarray(fn(jnp.asarray(img[i]), jnp.asarray(field[i]),
                                   4, interpret=True)).astype(np.float32)
                     for i in range(2)])
    got = TW.warp_pass(torch.tensor(img.astype(np.float32)).bfloat16(),
                       torch.tensor(field), 4, along_y=along_y)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("along_y", [False, True])
def test_warp_pass_plain_matches_xla_roll_form(along_y):
    img = _img(5, 2, 24, 40)
    field = _field(6, 2, 24, 40, 5.0)
    fn = JW._resample_cols_field if along_y else JW._resample_rows_field
    want = np.stack([np.asarray(fn(jnp.asarray(img[i]), jnp.asarray(field[i]),
                                   6)) for i in range(2)])
    got = _port(img, field, 6, along_y).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_warp_pass_out_of_frame_is_zero():
    img = _img(7, 1, 16, 16)
    field = np.full((1, 16, 16), 9.0, np.float32)     # src x + 9 > 15 from x = 7
    got = _port(img, field, 12, False).numpy()
    assert np.all(got[:, :, 7:] == 0.0)
    np.testing.assert_allclose(got, _pallas(img, field, 12, False),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_pass_identity_is_exact(dtype):
    img = torch.tensor(_img(8)).to(dtype)
    got = TW.warp_pass(img, torch.zeros(2, 32, 32), 4)
    assert torch.equal(got, img)


def test_warp_pass_takes_broadcast_fields():
    img = torch.tensor(_img(9))
    rows = torch.tensor(_field(10, 2, 32, 1, 3.0))[..., 0]     # [B, H]
    full = rows[:, :, None].expand(2, 32, 32)
    assert torch.equal(TW._resample_rows_roll(img, rows, 4),
                       TW.warp_pass(img, full.contiguous(), 4))


@pytest.mark.parametrize("max_deg", [10.0, 20.0])
def test_rotate_3shear_matches_jax(max_deg):
    img = _img(11, 3, 32, 32)
    theta = np.deg2rad(np.array([-max_deg, 0.3 * max_deg, max_deg * 0.97],
                                np.float32)).astype(np.float32)
    want = np.stack([np.asarray(JW.rotate_3shear(jnp.asarray(img[i]),
                                                 jnp.float32(theta[i]),
                                                 max_deg)) for i in range(3)])
    got = TW.rotate_3shear(torch.tensor(img), torch.tensor(theta), max_deg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _homographies(seed, b, size, scale=0.2):
    from vit_spoof_detection_pda_tpu.ops.augment import _perspective_homography
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return np.stack([np.asarray(_perspective_homography(k, size, size, scale))
                     for k in keys])


def test_perspective_warp_2pass_matches_jax():
    img = _img(12, 3, 32, 32)
    hm = _homographies(13, 3, 32)
    want = np.stack([np.asarray(JW.perspective_warp_2pass(
        jnp.asarray(img[i]), jnp.asarray(hm[i]), kmax=7)) for i in range(3)])
    got = TW.perspective_warp_2pass(torch.tensor(img), torch.tensor(hm), kmax=7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    fh, fv = TW.perspective_shift_fields(torch.tensor(hm), 32, 32)
    jf = [JW.perspective_shift_fields(jnp.asarray(hm[i]), 32, 32)
          for i in range(3)]
    np.testing.assert_allclose(fh.numpy(), np.stack([np.asarray(f[0])
                                                     for f in jf]), atol=1e-5)
    np.testing.assert_allclose(fv.numpy(), np.stack([np.asarray(f[1])
                                                     for f in jf]), atol=1e-5)


def test_displacement_warp_2pass_matches_jax():
    img = _img(14, 2, 32, 32)
    dy, dx = _field(15, 2, 32, 32, 3.0), _field(16, 2, 32, 32, 3.0)
    want = np.stack([np.asarray(JW.displacement_warp_2pass(
        jnp.asarray(img[i]), jnp.asarray(dy[i]), jnp.asarray(dx[i]), kmax=4))
        for i in range(2)])
    got = TW.displacement_warp_2pass(torch.tensor(img), torch.tensor(dy),
                                     torch.tensor(dx), kmax=4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bilinear_warps_match_jax():
    """The plain-PyTorch samplers behind random_rotation /
    random_perspective / elastic_transform and the gather oracle."""
    img = _img(17, 2, 20, 24)
    ang = np.array([0.3, -0.2], np.float32)
    m = TW.rotation_matrix(torch.tensor(ang), 9.5, 11.5)
    want = np.stack([np.asarray(JW.affine_warp(
        jnp.asarray(img[i]), JW.rotation_matrix(jnp.float32(ang[i]), 9.5,
                                                11.5))) for i in range(2)])
    np.testing.assert_allclose(TW.affine_warp(torch.tensor(img), m).numpy(),
                               want, atol=1e-5)
    hm = _homographies(18, 2, 20)[:, :, :]
    want = np.stack([np.asarray(JW.perspective_warp(jnp.asarray(img[i]),
                                                    jnp.asarray(hm[i])))
                     for i in range(2)])
    np.testing.assert_allclose(
        TW.perspective_warp(torch.tensor(img), torch.tensor(hm)).numpy(),
        want, atol=1e-5)
    dy, dx = _field(19, 2, 20, 24, 2.0), _field(20, 2, 20, 24, 2.0)
    want = np.stack([np.asarray(JW.displacement_warp(
        jnp.asarray(img[i]), jnp.asarray(dy[i]), jnp.asarray(dx[i])))
        for i in range(2)])
    np.testing.assert_allclose(TW.displacement_warp(
        torch.tensor(img), torch.tensor(dy), torch.tensor(dx)).numpy(),
        want, atol=1e-5)
    ys = _field(21, 2, 20, 24, 12.0) + 10
    xs = _field(22, 2, 20, 24, 14.0) + 12
    want = np.stack([np.asarray(JW.bilinear_sample_packed(
        jnp.asarray(img[i]), jnp.asarray(ys[i]), jnp.asarray(xs[i]),
        tap_dtype=jnp.bfloat16)) for i in range(2)])
    got = TW.bilinear_sample_packed(torch.tensor(img), torch.tensor(ys),
                                    torch.tensor(xs), tap_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_homography_from_points_matches_jax():
    rng = np.random.default_rng(23)
    dst = np.array([[0, 0], [31, 0], [31, 31], [0, 31]], np.float32)
    src = (dst + rng.uniform(-3, 3, (4, 4, 2))).astype(np.float32)
    got = TW.homography_from_points(torch.tensor(src),
                                    torch.tensor(dst).expand(4, 4, 2))
    want = np.stack([np.asarray(JW.homography_from_points(
        jnp.asarray(s), jnp.asarray(dst))) for s in src])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
