"""The port's module ``dtype`` policy, ``pool`` and ``ViTLinearHead``
against flax, with the weights carried across through the port's
converter (``models/convert.py::load_jax_params``).

Tolerances:
- f32: atol 2e-4 / rtol 1e-4 (tests/test_torch_vit.py's bound).
- bf16 logits: 3e-2 absolute against the jitted flax apply (the eval
  runner's program).  That is bf16's own spread at these widths: the
  same flax module applied eagerly and jitted differs by up to 1.6e-2 on
  these inputs, since XLA fuses and rounds at other points under jit,
  and per-layer ulp flips compound.  The repair itself is held bit for
  bit where no noise compounds: the attention sub-layer of the first
  block equals flax's eager bf16 output exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.ops import image as jimage
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit

SMALL = dict(patch_size=16, embed_dim=64, depth=2, num_heads=4, hidden=16)
WIDE = dict(patch_size=16, embed_dim=768, depth=1, num_heads=12, hidden=512)
BF16_TOL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _images(seed, b, img):
    u8 = np.random.default_rng(seed).integers(0, 256, (b, img, img, 3),
                                              dtype=np.uint8)
    return np.asarray(jimage.normalize(jimage.to_float(jnp.asarray(u8))))


def _close(got, want, dtype):
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= BF16_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom,img", [(SMALL, 32), (WIDE, 64)],
                         ids=["small", "vit_b_width"])
@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_antispoof_matches_flax(dtype, geom, img, gelu):
    jdt, tdt = DTYPES[dtype]
    jm = jvit.ViTAntiSpoof(**geom, dtype=jdt, gelu=gelu)
    variables = jm.init(jax.random.PRNGKey(img), jnp.zeros((1, img, img, 3)))
    x = _images(img, 4, img)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = tvit.ViTAntiSpoof(**geom, dtype=tdt, gelu=gelu, img_size=img).eval()
    tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.dtype == torch.float32        # the head's logits are f32
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_linear_head_matches_flax(dtype):
    """ViT-B/16 (12 layers, HF LayerNorm eps 1e-12) + the bare f32
    classifier, on 32x32 inputs (5 tokens)."""
    jdt, tdt = DTYPES[dtype]
    jm = jvit.ViTLinearHead(dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    x = _images(3, 2, 32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = tvit.ViTLinearHead(dtype=tdt, img_size=32).eval()
    tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    assert sorted(tm.state_dict()) == sorted(
        tconvert.vit_linear_to_torch(variables))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mean_pool_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    geom = dict(patch_size=16, embed_dim=64, depth=2, num_heads=4)
    jm = jvit.ViT(**geom, pool="mean", dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 48, 48, 3)))
    x = _images(4, 3, 48)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)),
                      np.float32)
    tm = tvit.ViT(**geom, pool="mean", dtype=tdt, img_size=48).eval()
    sd = tconvert.vit_backbone_to_timm(jax.tree.map(
        np.asarray, variables)["params"])
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.dtype == tdt and tuple(got.shape) == (3, 64)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    else:     # features in bf16: 2 ulps of their magnitude
        assert np.abs(got - want).max() <= 2 * 2.0 ** (
            np.floor(np.log2(np.abs(want).max())) - 7)


def test_unknown_pool_raises():
    with pytest.raises(ValueError, match="pool"):
        tvit.ViT(pool="max")


def test_bf16_policy_before_and_after():
    """Before the repair the port had only an f32 module; its attention
    sub-layer never equals flax's bf16 one.  After it, the bf16 module's
    first attention sub-layer is bit-equal to flax's (eager apply), its
    features are bf16 and its logits are f32 within BF16_TOL of the
    jitted flax module."""
    img = 32
    jm = jvit.ViTAntiSpoof(**SMALL, dtype=jnp.bfloat16)
    variables = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, img, img, 3)))
    x = _images(5, 4, img)
    _, state = jm.apply(variables, jnp.asarray(x), capture_intermediates=True)
    want_attn = np.asarray(state["intermediates"]["vit"]["block0"]["attn"]
                           ["__call__"][0], np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))

    def run(tdt):
        tm = tvit.ViTAntiSpoof(**SMALL, dtype=tdt, img_size=img).eval()
        tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
        seen = {}
        tm.vit.blocks[0].attn.register_forward_hook(
            lambda m, i, o: seen.setdefault("attn", o))
        tm.vit.register_forward_hook(lambda m, i, o: seen.setdefault("f", o))
        with torch.no_grad():
            logits = tm(torch.tensor(x))
        return seen["attn"], seen["f"], logits

    attn_f32, _, _ = run(torch.float32)                  # before
    attn, feats, logits = run(torch.bfloat16)            # after
    assert (attn_f32.numpy() != want_attn).mean() > 0.5
    assert attn.dtype == feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(attn.float().numpy(), want_attn)
    assert logits.dtype == torch.float32
    assert np.abs(logits.numpy() - want).max() <= BF16_TOL


def test_capture_path_equals_the_dispatched_core():
    """``capture=True`` (the attention-map tap) takes the dense einsum and
    keeps the f32 softmax; at f32 its logits equal the dispatched path's
    within 1e-6."""
    x = torch.tensor(_images(6, 2, 32))
    tm = tvit.ViTAntiSpoof(**SMALL, img_size=32).eval()
    cap = tvit.ViTAntiSpoof(**SMALL, img_size=32,
                            capture_attention=True).eval()
    cap.load_state_dict(tm.state_dict(), strict=True)
    with torch.no_grad():
        want, got = tm(x), cap(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    probs = cap.vit.blocks[1].attn.attn_probs
    assert probs.dtype == torch.float32 and tuple(probs.shape) == (2, 4, 5, 5)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
