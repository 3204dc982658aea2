"""The port at a token count past every one-block kernel limit of the
card (ViT at 304 px: T 362, Tp 368; the card's key-tiled routes take
these shapes, ops/attention.py's plans) against the JAX package, on the
CPU, at a small width: 2 heads of 64, depth 2, head hidden 16.

On the CPU the port's kernel wrappers run their plain versions, the same
functions the card's key-tiled kernels are held to
(tests/test_torch_kernels_cuda.py, chip_smoke.py's ``long`` phase); the
JAX side runs its Pallas kernels in interpret mode.  Inputs and weights
come from numpy seeds and flax's init, carried across by value.

Tolerances, beside their reasons (those of tests/test_torch_fasttrain.py
and tests/test_torch_attention_qkv.py, whose shapes are smaller):
- f32 forward outputs: atol 2e-4 / rtol 1e-4; f32 gradients: atol 1e-4
  / rtol 2e-3.  The same f32 math, summed in other orders (GEMMs, the
  softmax over 362 keys, LN means, batch sums of the weight gradients).
- the f32 attention core: atol 2e-6 / rtol 1e-5; its backward atol 1e-5
  / rtol 1e-4.
- bf16 attention core: 2 bf16 ulps of the largest output magnitude.
- bf16 logits of the whole model: atol 0.05 / rtol 0.05.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import fasttrain as JFT
from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.ops import attention as jatt
from vit_spoof_detection_pda_tpu.ops.attention import attention_sharding
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import fasttrain as TFT
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof as TViT
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt
from vit_spoof_detection_pda_tpu_torch.train.state import tree_flatten

IMG, D, HEADS, DEPTH = 304, 128, 2, 2
T = (IMG // 16) ** 2 + 1                    # 362 tokens
FWD_TOL = dict(atol=2e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=2e-3)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_tol(want):
    amax = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _models(dtype="f32"):
    jm = JViT(patch_size=16, embed_dim=D, depth=DEPTH, num_heads=HEADS,
              hidden=16, dtype=DT[dtype][0])
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)))
    tm = TViT(embed_dim=D, depth=DEPTH, num_heads=HEADS, hidden=16,
              img_size=IMG, dtype=DT[dtype][1])
    return jm, variables, tm


def _torch_params(variables):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, np.float32), requires_grad=True)
    return walk(dict(variables["params"]))


def _batch(b=2):
    return np.random.default_rng(11).standard_normal(
        (b, IMG, IMG, 3)).astype(np.float32)


def _nll(logits, labels, xp):
    if xp is jnp:
        return -jnp.mean(jax.nn.log_softmax(logits)[
            jnp.arange(len(labels)), labels])
    return -torch.log_softmax(logits, -1)[
        torch.arange(len(labels)), labels].mean()


def test_the_shape_is_past_every_one_block_limit():
    """T 362 (Tp 368) takes the key-tiled route of every plan at head dim
    64 in both dtypes, bar kernel 12's two-pass form (also the bf16
    attention stage of the blocks), which holds 368 keys whole."""
    tp = tatt._round_up(T, 8)
    for dt in (torch.bfloat16, torch.float32):
        assert tatt.attention_qkv_bwd_plan(2, tp, HEADS, 64, dt)[
            "route"] == "key_tiled"
        assert tatt.cp_bwd_plan(2, tp, tp, HEADS, 64, dt)[
            "route"] == "key_tiled"
    assert tatt.module_attention_plan(T, 64, torch.float32)[
        "form"] == "key_tiled"
    assert tatt.module_attention_plan(tp, 64, torch.float32)[
        "form"] == "key_tiled"
    # the blocks' bf16 attention stage: kernel 12's two passes, K and V whole
    assert tatt.module_attention_plan(tp, 64, torch.bfloat16)[
        "form"] == "two_pass"


def test_train_forward_logits_and_every_param_grad_match_jax_f32():
    jm, variables, tm = _models()
    x = _batch()
    labels = np.array([1, 0])
    with attention_sharding(interpret=True):
        jfast = JFT.make_apply(jm)
        want_logits = np.asarray(jfast(variables, jnp.asarray(x)))
        want = jax.grad(lambda p: _nll(jfast({"params": p}, jnp.asarray(x)),
                                       jnp.asarray(labels), jnp))(
            variables["params"])
    params = _torch_params(variables)
    logits = TFT.make_apply(tm, dtype=torch.float32)(
        {"params": params}, torch.tensor(x))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               **FWD_TOL)
    _nll(logits, torch.tensor(labels), torch).backward()
    got_leaves, got_paths = tree_flatten(params)
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_flat) == DEPTH * 12 + 6 + 6
    for leaf, path, (jpath, jleaf) in zip(got_leaves, got_paths, want_flat):
        assert tuple(k.key for k in jpath) == path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jleaf),
                                   err_msg=str(path), **GRAD_TOL)


def test_train_forward_bf16_logits_close_to_jax():
    jm, variables, tm = _models("bf16")
    x = _batch()
    with attention_sharding(interpret=True):
        want = np.asarray(JFT.make_apply(jm)(variables, jnp.asarray(x)),
                          np.float32)
    params = _torch_params(variables)
    logits = TFT.make_apply(tm, dtype=torch.bfloat16)(
        {"params": params}, torch.tensor(x))
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=0.05,
                               rtol=0.05)
    (logits ** 2).mean().backward()
    for leaf in tree_flatten(params)[0]:
        assert torch.isfinite(leaf.grad).all()


def test_module_forward_f32_matches_flax():
    """The module path (the ``test`` verb's and ``evaluate-all``'s
    forward, kernel 8 f32 on the card) against flax's module."""
    jm, variables, tm = _models()
    x = _batch()
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        got = tm.eval()(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("dtype", list(DT))
def test_attention_core_matches_jax_kernel(dtype):
    """fused_attention_qkv at T 362 (kernel 8 / its key-tiled f32 core on
    the card) against JAX's ``fused_attention_qkv(interpret=True)``."""
    jdt, tdt = DT[dtype]
    x = np.random.default_rng(12).standard_normal(
        (2, T, 3 * D)).astype(np.float32)
    want = np.asarray(jatt.fused_attention_qkv(jnp.asarray(x, jdt), HEADS,
                                               True), np.float32)
    got = tatt.fused_attention_qkv(torch.tensor(x).to(tdt), HEADS)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= _bf16_tol(want)


def test_attention_core_backward_matches_jax_vjp_f32():
    """Its backward at T 362 (the key-tiled backward on the card) against
    ``jax.vjp`` of the interpret-mode kernel."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, T, 3 * D)).astype(np.float32)
    g = rng.standard_normal((2, T, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda q: jatt.fused_attention_qkv(q, HEADS, True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.tensor(x, requires_grad=True)
    tatt.fused_attention_qkv(xt, HEADS).backward(torch.tensor(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=1e-4)
