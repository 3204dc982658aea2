"""The port's training forward and its backward (models/fasttrain.py)
against the JAX package's, on the same numpy-seeded inputs and weights,
at a small geometry: D 64, 4 heads, depth 2, head hidden 16, 32x32 images.

On the CPU the port's kernel wrappers run their plain versions; the JAX
side runs its Pallas kernels in interpret mode (``interpret=True``, and
``attention_sharding(interpret=True)`` around ``make_apply``).  The CUDA
kernels are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances, beside their reasons:
- f32 forward outputs: atol 2e-4 / rtol 1e-4, and f32 gradients: atol
  1e-4 / rtol 2e-3, the bounds of tests/test_fasttrain.py.  Both sides run
  the same f32 math; the sums (GEMMs, softmax, LN means, batch sums of the
  weight grads) are taken in other orders.
- bf16 block outputs: 2 bf16 ulps of the largest magnitude (the same
  rounding points; a different f32 sum order can flip one rounding).
- bf16 logits of the whole model: atol 0.05 / rtol 0.05, the bound
  tests/test_fasttrain.py puts on the JAX fast path's own bf16 logits.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.models import fasttrain as JFT
from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.ops import attention as jatt
from vit_spoof_detection_pda_tpu.ops.attention import attention_sharding
from vit_spoof_detection_pda_tpu_torch.models import fasttrain as TFT
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof as TViT
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt
from vit_spoof_detection_pda_tpu_torch.train.state import tree_flatten

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=2e-3)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
ATTN_NAMES = "x lns lnb wqkv bqkv wproj bproj".split()
MLP_NAMES = "x lns lnb w1 b1 w2 b2".split()


def _bf16_tol(want):
    amax = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _close(got, want, dtype, tol=FWD_TOL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
    else:
        assert np.abs(got - want).max() <= _bf16_tol(want), what


def _np(t):
    return t.detach().float().numpy()


def _attn_args(seed, b, t, d):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(  # noqa: E731
        np.float32)
    return [f(b, t, d), 1.0 + f(d, std=0.1), f(d, std=0.1),
            f(d, 3 * d, std=d ** -0.5), f(3 * d, std=0.05),
            f(d, d, std=d ** -0.5), f(d, std=0.05)]


def _mlp_args(seed, b, t, d, hidden):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(  # noqa: E731
        np.float32)
    return [f(b, t, d), 1.0 + f(d, std=0.1), f(d, std=0.1),
            f(d, hidden, std=d ** -0.5), f(hidden, std=0.05),
            f(hidden, d, std=hidden ** -0.5), f(d, std=0.05)]


_COMPUTE = (0, 3, 5)       # x and the two matrices are in the compute dtype


def _jax_args(args, jdt):
    return [jnp.asarray(a, jdt if i in _COMPUTE else jnp.float32)
            for i, a in enumerate(args)]


def _torch_args(args, tdt, grad=False):
    return [torch.tensor(a, dtype=tdt if i in _COMPUTE else torch.float32,
                         requires_grad=grad) for i, a in enumerate(args)]


# --------------------------------------------------------------------------
# kernel 3: training attention block forward, five outputs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,t", [(2, 17), (3, 33)])
def test_attn_block_train_fwd_matches_jax_kernel(dtype, b, t):
    d, heads = 64, 4
    jdt, tdt = DT[dtype]
    args = _attn_args(0, b, t, d)
    want = JFT._attn_block_fwd_pallas(*_jax_args(args, jdt), heads, 1e-6,
                                      True)
    got = TFT.attn_block_train_fwd(*_torch_args(args, tdt), heads, 1e-6)
    names = ("o", "qkv", "attn", "xh", "inv")
    tp = tatt._round_up(t, 8)
    assert got[1].shape == (b, tp, 3 * d) and got[4].shape == (b, tp, 1)
    for name, g_, w_ in zip(names, got, want):
        assert g_.dtype == (torch.float32 if name == "inv" else tdt), name
        _close(_np(g_), w_, "f32" if name == "inv" else dtype, what=name)


# --------------------------------------------------------------------------
# kernel 4: attention backward on prepadded residuals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,tp,t,d,heads", [(2, 24, 17, 64, 4),
                                            (3, 200, 197, 128, 2)])
def test_attention_qkv_bwd_plain_matches_jax_kernel(dtype, b, tp, t, d,
                                                    heads):
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((b, tp, 3 * d)).astype(np.float32)
    g = rng.standard_normal((b, tp, d)).astype(np.float32)
    g[:, t:] = 0.0                       # pad rows carry no cotangent
    want = jatt._backward_qkv(jnp.asarray(qkv, jdt), jnp.asarray(g, jdt),
                              heads, interpret=True, valid_len=t)
    got = tatt.attention_qkv_bwd(torch.tensor(qkv).to(tdt),
                                 torch.tensor(g).to(tdt), heads,
                                 valid_len=t)
    assert got.dtype == tdt and got.shape == (b, tp, 3 * d)
    for part, name in enumerate("dq dk dv".split()):
        cols = slice(part * d, (part + 1) * d)
        _close(_np(got)[..., cols], np.asarray(want, np.float32)[..., cols],
               dtype, what=name)
    assert (_np(got)[:, t:] == 0).all()


# --------------------------------------------------------------------------
# the two sub-layers' gradients against jax.grad
# --------------------------------------------------------------------------


def _block_grads(j_fn, t_fn, args, static_j, static_t, seed):
    w = np.random.default_rng(seed).standard_normal(
        args[0].shape).astype(np.float32)
    ja = _jax_args(args, jnp.float32)

    def loss(*a):
        return jnp.sum(j_fn(*a, *static_j) * w)

    want_out = j_fn(*ja, *static_j)
    want = jax.grad(loss, argnums=tuple(range(7)))(*ja)
    ta = _torch_args(args, torch.float32, grad=True)
    out = t_fn(*ta, *static_t)
    (out * torch.tensor(w)).sum().backward()
    return out, want_out, [a.grad for a in ta], want


@pytest.mark.parametrize("b,t", [(2, 17), (1, 24)])
def test_attn_block_train_grads_match_jax(b, t):
    d, heads = 64, 4
    out, want_out, got, want = _block_grads(
        JFT.attn_block_train, TFT.AttnBlockTrain.apply,
        _attn_args(2, b, t, d), (heads, 1e-6, True), (heads, 1e-6), 3)
    _close(_np(out), want_out, "f32")
    for name, g_, w_ in zip(ATTN_NAMES, got, want):
        _close(_np(g_), w_, "f32", GRAD_TOL, what=f"grad {name}")


@pytest.mark.parametrize("approx", [False, True])
def test_mlp_block_train_h_grads_match_jax(approx):
    out, want_out, got, want = _block_grads(
        JFT.mlp_block_train_h, TFT.MlpBlockTrainH.apply,
        _mlp_args(4, 2, 17, 64, 256), (approx, 1e-6, True), (approx, 1e-6),
        5)
    _close(_np(out), want_out, "f32")
    for name, g_, w_ in zip(MLP_NAMES, got, want):
        _close(_np(g_), w_, "f32", GRAD_TOL, what=f"grad {name}")


def test_gelu_lean_matches_jax():
    """The forward is the same formula (1e-6); the port writes the
    derivative out where JAX differentiates the formula, so the gradients
    differ by a few f32 ulps of values up to about 1.1 (atol 1e-5)."""
    x = np.random.default_rng(6).standard_normal(257).astype(np.float32) * 3
    for approx in (False, True):
        jy, jvjp = jax.vjp(lambda v: JFT.gelu_lean(v, approx), jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        ty = TFT.gelu_lean(tx, approx)
        ty.backward(torch.ones_like(ty))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            tx.grad.numpy(), np.asarray(jvjp(jnp.ones_like(jy))[0]),
            atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# the whole training forward against JAX make_apply
# --------------------------------------------------------------------------


def _models(dtype="f32", depth=2):
    jm = JViT(patch_size=16, embed_dim=64, depth=depth, num_heads=4,
              hidden=16, dtype=DT[dtype][0])
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = TViT(embed_dim=64, depth=depth, num_heads=4, hidden=16,
              img_size=32)
    return jm, variables, tm


def _torch_params(variables, grad=True):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, np.float32), requires_grad=grad)
    return walk(dict(variables["params"]))


def _batch(b=2):
    return np.random.default_rng(0).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def _nll(logits, labels, xp):
    """Mean negative log-likelihood, written for either framework."""
    if xp is jnp:
        return -jnp.mean(jax.nn.log_softmax(logits)[
            jnp.arange(len(labels)), labels])
    return -torch.log_softmax(logits, -1)[
        torch.arange(len(labels)), labels].mean()


@pytest.mark.parametrize("mlp_mode", ["hidden", "autodiff"])
def test_train_forward_logits_and_every_param_grad_match_jax_f32(mlp_mode):
    jm, variables, tm = _models()
    x = _batch()
    labels = np.array([0, 1])
    with attention_sharding(interpret=True):
        jfast = JFT.make_apply(jm, mlp_mode=mlp_mode)
        want_logits = np.asarray(jfast(variables, jnp.asarray(x)))
        want = jax.grad(lambda p: _nll(jfast({"params": p}, jnp.asarray(x)),
                                       jnp.asarray(labels), jnp))(
            variables["params"])
    params = _torch_params(variables)
    tfast = TFT.make_apply(tm, dtype=torch.float32, mlp_mode=mlp_mode)
    logits = tfast({"params": params}, torch.tensor(x))
    np.testing.assert_allclose(_np(logits), want_logits, **FWD_TOL)
    _nll(logits, torch.tensor(labels), torch).backward()

    got_leaves, got_paths = tree_flatten(params)
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_flat) == 2 * 12 + 6 + 6
    for leaf, path, (jpath, jleaf) in zip(got_leaves, got_paths, want_flat):
        assert tuple(k.key for k in jpath) == path
        assert leaf.grad is not None, path
        np.testing.assert_allclose(
            leaf.grad.numpy(), np.asarray(jleaf), err_msg=str(path),
            **GRAD_TOL)


def test_train_forward_bf16_logits_finite_and_close_to_jax():
    jm, variables, tm = _models("bf16")
    x = _batch()
    with attention_sharding(interpret=True):
        want = np.asarray(JFT.make_apply(jm)(variables, jnp.asarray(x)),
                          np.float32)
    params = _torch_params(variables)
    tfast = TFT.make_apply(tm, dtype=torch.bfloat16)
    logits = tfast({"params": params}, torch.tensor(x))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), want, atol=0.05, rtol=0.05)
    (logits ** 2).mean().backward()
    for leaf in tree_flatten(params)[0]:
        assert torch.isfinite(leaf.grad).all()


def test_eval_forward_takes_the_serving_attention_block():
    """Grad off: the attention sub-layer is the serving block (kernel 1),
    with the same logits as the training block's forward."""
    _, variables, tm = _models()
    params = _torch_params(variables)
    tfast = TFT.make_apply(tm, dtype=torch.float32)
    x = torch.tensor(_batch())
    with torch.no_grad():
        eval_logits = tfast({"params": params}, x)
    train_logits = tfast({"params": params}, x)
    assert train_logits.grad_fn is not None and eval_logits.grad_fn is None
    np.testing.assert_allclose(_np(eval_logits), _np(train_logits),
                               atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# dropout, and what this slice leaves out
# --------------------------------------------------------------------------


def test_dropout_semantics():
    """torch.Generator bits are not jax.random's, so dropout is checked on
    its own: train mode with a generator moves the logits, the same seed
    replays them, eval ignores dropout, and kept values scale by 1/keep."""
    _, variables, tm = _models()
    params = _torch_params(variables, grad=False)
    fast = TFT.make_apply(tm, dtype=torch.float32)
    x = torch.tensor(_batch(4))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    a = fast({"params": params}, x, train=True, generator=gen(1))
    a2 = fast({"params": params}, x, train=True, generator=gen(1))
    b_ = fast({"params": params}, x, train=True, generator=gen(2))
    e = fast({"params": params}, x)
    e2 = fast({"params": params}, x, generator=gen(3))
    assert torch.equal(a, a2)
    assert not torch.allclose(a, b_) and not torch.allclose(a, e)
    assert torch.equal(e, e2)

    ones = torch.ones(20000)
    out = TFT._dropout(gen(4), ones, 0.1, True)
    kept = out[out != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.9))
    assert abs(kept.numel() / ones.numel() - 0.9) < 0.01
    assert torch.equal(TFT._dropout(gen(4), ones, 0.1, False), ones)


def test_train_with_dropout_needs_a_generator():
    _, variables, tm = _models()
    fast = TFT.make_apply(tm, dtype=torch.float32)
    with pytest.raises(ValueError, match="generator"):
        fast({"params": _torch_params(variables)}, torch.tensor(_batch()),
             train=True)


@pytest.mark.parametrize("mode", ["xhat", "fused"])
def test_unported_mlp_modes_raise(mode):
    """The two modes that raised before the training loop was ported now
    train: at f32 on the CPU their logits and every gradient leaf equal
    the "hidden" mode's within 1e-6 (the same f32 math, other sum
    orders; tests/test_torch_mlp_modes.py holds them against JAX).  An
    unknown mode still raises, at make_apply and at train_forward."""
    _, variables, tm = _models()
    x = torch.tensor(_batch())
    out = {}
    for m in (mode, "hidden"):
        params = _torch_params(variables)
        logits = TFT.make_apply(tm, dtype=torch.float32, mlp_mode=m)(
            {"params": params}, x)
        (logits ** 2).sum().backward()
        out[m] = (logits, [p.grad for p in tree_flatten(params)[0]])
    np.testing.assert_allclose(_np(out[mode][0]), _np(out["hidden"][0]),
                               atol=1e-6, rtol=1e-6)
    for g, h in zip(out[mode][1], out["hidden"][1]):
        np.testing.assert_allclose(g.numpy(), h.numpy(), atol=1e-6,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="unknown mlp_mode"):
        TFT.make_apply(tm, mlp_mode="dense")
    with pytest.raises(ValueError, match="unknown mlp_mode"):
        TFT.train_forward(_torch_params(variables), x, mlp_mode="dense")


def test_make_apply_takes_only_the_antispoof_model():
    assert TFT.fast_apply_available(TViT(embed_dim=64, depth=1, num_heads=4,
                                         hidden=16, img_size=32))
    assert not TFT.fast_apply_available(torch.nn.Linear(2, 2))
    with pytest.raises(TypeError, match="ViTAntiSpoof"):
        TFT.make_apply(torch.nn.Linear(2, 2))
