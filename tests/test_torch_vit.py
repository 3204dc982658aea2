"""The port's model layer against the JAX package: converter, module
forward (erf and tanh GELU, small and full ViT-B width), normalization
folding, patchify, image normalization and GELU.

Inputs and weights come from numpy seeds or a flax init and reach both
sides as numpy arrays.  Module logits are compared in f32 at atol 2e-4 /
rtol 1e-4 (tests/test_fastserve.py's bound); the port's module uses a
conv for the patch embed where JAX uses a GEMM, so the two sum in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import convert as jconvert
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.ops import image as jimage
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.ops import gelu as tgelu
from vit_spoof_detection_pda_tpu_torch.ops import image as timage

SMALL = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)


def _pair(geom, img, gelu, seed=0):
    """A flax ViTAntiSpoof with its init, and the port's module loaded
    from it through the port's converter."""
    jm = jvit.ViTAntiSpoof(**geom, gelu=gelu)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
    tm = tvit.ViTAntiSpoof(**geom, gelu=gelu, img_size=img).eval()
    tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    return jm, variables, tm


def _images(seed, b, img):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8)


def _logits_both(jm, variables, tm, u8):
    x = np.asarray(jimage.normalize(jimage.to_float(jnp.asarray(u8))))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    return got, want


def test_converter_matches_jax_exporter_and_loads_strict():
    jm, variables, tm = _pair(SMALL, 32, "erf")
    want = jconvert.antispoof_to_torch(variables)
    got = tconvert.antispoof_to_torch(jax.tree.map(np.asarray, variables))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the exporter's key set is exactly the module's (strict load above)
    assert sorted(tm.state_dict()) == sorted(want)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_converter_inverse_roundtrips_the_tree():
    _jm, variables, tm = _pair(SMALL, 32, "erf", seed=1)
    back = tconvert.antispoof_from_torch(tm.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf),
                                      err_msg=str(path))


def test_load_rejects_a_mismatched_tree():
    _jm, variables, _tm = _pair(SMALL, 32, "erf")
    deeper = tvit.ViTAntiSpoof(**dict(SMALL, depth=3), img_size=32)
    with pytest.raises(RuntimeError, match="Missing key"):
        tconvert.load_jax_params(deeper, jax.tree.map(np.asarray, variables))


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_module_logits_match_flax_small(gelu):
    jm, variables, tm = _pair(SMALL, 32, gelu)
    got, want = _logits_both(jm, variables, tm, _images(1, 4, 32))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_module_logits_match_flax_full_width(gelu):
    """ViT-B/16 widths (D 768, 12 heads, 224x224, head 512), one layer."""
    geom = dict(patch_size=16, embed_dim=768, depth=1, num_heads=12,
                hidden=512)
    jm, variables, tm = _pair(geom, 224, gelu, seed=2)
    got, want = _logits_both(jm, variables, tm, _images(2, 2, 224))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_dropout_is_off_in_eval_mode():
    _jm, _v, tm = _pair(SMALL, 32, "erf")
    x = torch.tensor(_images(3, 2, 32), dtype=torch.float32) / 255.0
    with torch.no_grad():
        a, b = tm(x), tm(x)
    assert torch.equal(a, b)
    tm.train()
    with torch.no_grad():
        drawn = [tm(x) for _ in range(4)]
    assert any(not torch.equal(drawn[0], d) for d in drawn[1:])


def test_fold_normalization_matches_jax():
    _jm, variables, _tm = _pair(SMALL, 32, "erf", seed=3)
    want = jvit.fold_normalization(variables)["params"]["vit"]["patch_embed"]
    got = tvit.fold_normalization(jax.tree.map(np.asarray, variables))
    got = got["params"]["vit"]["patch_embed"]
    np.testing.assert_array_equal(got["kernel"].numpy(),
                                  np.asarray(want["kernel"]))
    # the bias is a 768-term f32 dot, summed in another order
    np.testing.assert_allclose(got["bias"].numpy(), np.asarray(want["bias"]),
                               atol=1e-5, rtol=1e-5)


def test_folded_weights_on_raw_pixels_match_normalized_input():
    jm, variables, tm = _pair(SMALL, 32, "erf", seed=4)
    u8 = _images(4, 3, 32)
    got_norm, _ = _logits_both(jm, variables, tm, u8)
    folded = tvit.fold_normalization(jax.tree.map(np.asarray, variables))
    tconvert.load_jax_params(tm, folded)
    with torch.no_grad():
        got_raw = tm(torch.tensor(u8, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got_raw, got_norm, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)])
def test_patchify_matches_jax(dtype):
    u8 = _images(5, 2, 48)
    want = np.asarray(jvit.patchify(jnp.asarray(u8), patch_size=16,
                                    dtype=dtype[0]), np.float32)
    got = tvit.patchify(torch.tensor(u8), patch_size=16, dtype=dtype[1])
    assert got.dtype == dtype[1] and got.shape == (2, 9, 768)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_image_normalization_matches_jax():
    u8 = _images(6, 2, 16)
    np.testing.assert_array_equal(
        timage.to_float(torch.tensor(u8)).numpy(),
        np.asarray(jimage.to_float(jnp.asarray(u8))))
    x = np.random.default_rng(7).random((2, 16, 16, 3), dtype=np.float32)
    np.testing.assert_allclose(
        timage.normalize(torch.tensor(x)).numpy(),
        np.asarray(jimage.normalize(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = timage.normalize_u8_fused(torch.tensor(u8), dtype=tdt)
        want = jimage.normalize_u8_fused(jnp.asarray(u8), dtype=jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = np.random.default_rng(8).standard_normal(4096).astype(np.float32) * 4
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=approximate))
    got = tgelu.gelu(torch.tensor(x), approximate).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
