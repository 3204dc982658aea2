"""The two MLP modes the training loop brought: ``"xhat"`` (the
recompute-hidden backward, JAX ``mlp_block_train``) and ``"fused"`` (the
training MLP kernel, kernel 7, under the stored-hidden backward, JAX
``mlp_block_train_p``), against the JAX package on numpy-seeded inputs at
a small geometry (D 64, hidden 256), plus the whole training forward in
each mode against JAX ``make_apply``.

On the CPU the port runs kernel 7's plain version
(``ops/attention.py::mlp_block_train_plain``); the JAX side runs its
Pallas kernel in interpret mode.  The card holds the kernel against the
plain version (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances, beside their reasons:
- f32: the bounds of tests/test_torch_fasttrain.py (forward atol 2e-4 /
  rtol 1e-4, gradients atol 1e-4 / rtol 2e-3): the same f32 math, other
  sum orders.  The JAX fused kernel's erf is the A&S rational (|error|
  <= 1.5e-7) where the port's is exact; at f32 that is far inside these.
- bf16 kernel-7 outputs: 2 bf16 ulps of the largest magnitude (the same
  rounding points, so a flipped rounding moves an output by about one
  ulp; the A&S erf can flip the GELU output's rounding too).
- ``"fused"`` against ``"hidden"`` at bf16 (the reference deviation
  ROADMAP calls the fused-MLP GELU mismatch is JAX's, not the port's):
  the output within 2 bf16 ulps, every gradient within 1e-2 relative L2
  (the backward is one code path; only the forward's rounded hidden can
  differ by an ulp, and bf16 products carry it on).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.models import fasttrain as JFT
from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.ops.attention import attention_sharding
from vit_spoof_detection_pda_tpu_torch.models import fasttrain as TFT
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof as TViT
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt
from vit_spoof_detection_pda_tpu_torch.train.state import tree_flatten

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=2e-3)
NAMES = "x lns lnb w1 b1 w2 b2".split()
_COMPUTE = (0, 3, 5)


def _args(seed, b=2, t=17, d=64, hidden=256):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(  # noqa: E731
        np.float32)
    return [f(b, t, d), 1.0 + f(d, std=0.1), f(d, std=0.1),
            f(d, hidden, std=d ** -0.5), f(hidden, std=0.05),
            f(hidden, d, std=hidden ** -0.5), f(d, std=0.05)]


def _jax(args, jdt=jnp.float32):
    return [jnp.asarray(a, jdt if i in _COMPUTE else jnp.float32)
            for i, a in enumerate(args)]


def _torch(args, tdt=torch.float32, grad=False):
    return [torch.tensor(a, dtype=tdt if i in _COMPUTE else torch.float32,
                         requires_grad=grad) for i, a in enumerate(args)]


def _np(t):
    return t.detach().float().numpy()


def _bf16_tol(want):
    amax = float(np.abs(np.asarray(want, np.float32)).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)


def _grads(j_fn, static_j, t_fn, static_t, args, seed):
    w = np.random.default_rng(seed).standard_normal(
        args[0].shape).astype(np.float32)
    ja = _jax(args)
    want_out = j_fn(*ja, *static_j)
    want = jax.grad(lambda *a: jnp.sum(j_fn(*a, *static_j) * w),
                    argnums=tuple(range(7)))(*ja)
    ta = _torch(args, grad=True)
    out = t_fn(*ta, *static_t)
    (out * torch.tensor(w)).sum().backward()
    return out, want_out, [a.grad for a in ta], want


@pytest.mark.parametrize("approx", [False, True])
def test_xhat_mode_matches_jax_mlp_block_train(approx):
    out, want_out, got, want = _grads(
        JFT.mlp_block_train, (approx, 1e-6), TFT.MlpBlockTrainX.apply,
        (approx, 1e-6), _args(1), 2)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), **FWD_TOL)
    for name, g_, w_ in zip(NAMES, got, want):
        np.testing.assert_allclose(_np(g_), np.asarray(w_),
                                   err_msg=f"grad {name}", **GRAD_TOL)


@pytest.mark.parametrize("approx", [False, True])
def test_fused_mode_matches_jax_mlp_block_train_p(approx):
    """Kernel 7's plain version under the stored-hidden backward against
    JAX's fused kernel (interpret) and its backward, at f32."""
    out, want_out, got, want = _grads(
        JFT.mlp_block_train_p, (approx, 1e-6, True),
        TFT.MlpBlockTrainP.apply, (approx, 1e-6), _args(3), 4)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), **FWD_TOL)
    for name, g_, w_ in zip(NAMES, got, want):
        np.testing.assert_allclose(_np(g_), np.asarray(w_),
                                   err_msg=f"grad {name}", **GRAD_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("b,t", [(2, 17), (1, 128)])
def test_kernel7_plain_matches_the_jax_kernel(dtype, approx, b, t):
    """The four outputs of kernel 7's plain version against JAX
    ``_mlp_fwd_pallas`` (interpret), which pads the rows to 128: its first
    B*T rows."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    args = _args(5, b, t)
    y, xh, inv, h = JFT._mlp_fwd_pallas(*_jax(args, jdt), approx, 1e-6,
                                        True)
    ta = _torch(args, tdt)
    rows = b * t
    got = tatt.mlp_block_train_plain(ta[0].reshape(rows, -1), *ta[1:],
                                     approximate=approx)
    want = (np.asarray(y, np.float32).reshape(rows, -1),
            *(np.asarray(a, np.float32)[:rows] for a in (xh, inv, h)))
    for name, g_, w_ in zip(("y", "xhat", "inv", "h"), got, want):
        assert g_.shape == w_.shape, name
        assert g_.dtype == (torch.float32 if name == "inv" else tdt), name
        if dtype == "f32" or name == "inv":
            np.testing.assert_allclose(_np(g_), w_, err_msg=name, **FWD_TOL)
        else:
            assert np.abs(_np(g_) - w_).max() <= _bf16_tol(w_), name


def test_fused_mode_matches_hidden_mode_at_bf16():
    args = _args(6, 2, 33)
    out = {}
    for mode, fn in (("fused", TFT.MlpBlockTrainP.apply),
                     ("hidden", TFT.MlpBlockTrainH.apply)):
        ta = _torch(args, torch.bfloat16, grad=True)
        y = fn(*ta, False, 1e-6)
        (y.float() ** 2).sum().backward()
        out[mode] = (y, [a.grad for a in ta])
    yf, yh = _np(out["fused"][0]), _np(out["hidden"][0])
    assert np.abs(yf - yh).max() <= _bf16_tol(yh)
    for name, gf, gh in zip(NAMES, out["fused"][1], out["hidden"][1]):
        gf, gh = gf.float(), gh.float()
        rel = ((gf - gh).norm() / gh.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-2, (name, rel)


def _models():
    jm = JViT(patch_size=16, embed_dim=64, depth=2, num_heads=4, hidden=16)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = TViT(embed_dim=64, depth=2, num_heads=4, hidden=16, img_size=32)
    return jm, variables, tm


@pytest.mark.parametrize("mlp_mode", ["xhat", "fused"])
def test_train_forward_in_each_new_mode_matches_jax_make_apply(mlp_mode):
    """The whole training forward (logits) and every parameter leaf's
    gradient against JAX ``make_apply(mlp_mode=...)`` at f32."""
    jm, variables, tm = _models()
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    labels = np.array([0, 1])
    with attention_sharding(interpret=True):
        jfast = JFT.make_apply(jm, mlp_mode=mlp_mode)

        def loss(p):
            logits = jfast({"params": p}, jnp.asarray(x))
            return -jnp.mean(jax.nn.log_softmax(logits)[
                jnp.arange(2), jnp.asarray(labels)])

        want_logits = np.asarray(jfast(variables, jnp.asarray(x)))
        want = jax.grad(loss)(variables["params"])
    params = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                                 requires_grad=True),
                          dict(variables["params"]))
    logits = TFT.make_apply(tm, mlp_mode=mlp_mode)({"params": params},
                                                   torch.tensor(x))
    np.testing.assert_allclose(_np(logits), want_logits, **FWD_TOL)
    (-torch.log_softmax(logits, -1)[torch.arange(2),
                                    torch.tensor(labels)].mean()).backward()
    leaves, paths = tree_flatten(params)
    wants = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(leaves) == len(wants)
    for leaf, path, (jpath, jleaf) in zip(leaves, paths, wants):
        assert tuple(k.key for k in jpath) == path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jleaf),
                                   err_msg=str(path), **GRAD_TOL)
