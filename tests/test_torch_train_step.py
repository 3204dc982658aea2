"""The port's train and eval steps and optimizer (train/{state,step}.py)
against the JAX package's, on the same weights and batch, at f32 with
dropout off, at a small geometry (D 64, 4 heads, depth 2, head hidden 16,
32x32 images).

The JAX side is ``make_train_step`` + ``make_optimizer`` +
``make_lr_schedule`` + focal loss over the flax module; the port runs its
fused training forward (plain versions of the kernels on the CPU), which
tests/test_torch_fasttrain.py holds against the JAX fused forward leaf by
leaf.

Tolerances, beside their reasons:
- loss, accuracy and grad_norm: rtol 1e-4 (f32; the sums run in another
  order on each side).
- parameters after a step: atol 1e-5 (3% of the lr).  Adam's first
  update is about ``lr * g / (|g| + 1e-8)`` per element, so a gradient
  that differs by 1e-4 relative moves the parameter by far less than
  1e-6, except where ``|g|`` is near 1e-8 and the rounding of ``g`` is
  amplified (one element in 16,384 moved 2.6e-6); a parameter whose
  gradient changed sign would be off by ``2 lr`` = 6e-4.  That is the
  case of the key third of each qkv bias: softmax ignores a constant
  added to every key of a query, so its gradient is zero in exact
  arithmetic and both sides normalise rounding noise of about 1e-10 to
  ``+-lr``.  Those elements are held to atol ``2 lr`` (and to move by no
  more than ``lr`` per step plus the decay).
- the optimizer fed identical gradients: atol 1e-7 / rtol 1e-6 (the same
  f32 formulas; only the global norm's sum order differs).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.ops import losses as jl
from vit_spoof_detection_pda_tpu.train import make_eval_step as j_eval_step
from vit_spoof_detection_pda_tpu.train import make_train_step as j_train_step
from vit_spoof_detection_pda_tpu.train.schedule import make_lr_schedule as j_sched
from vit_spoof_detection_pda_tpu.train.state import (
    create_train_state as j_create, find_ema_params as j_find_ema,
    make_optimizer as j_make_optimizer)
from vit_spoof_detection_pda_tpu_torch.models.fasttrain import make_apply
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof as TViT
from vit_spoof_detection_pda_tpu_torch.ops import losses as tl
from vit_spoof_detection_pda_tpu_torch.train import schedule as ts
from vit_spoof_detection_pda_tpu_torch.train import state as S
from vit_spoof_detection_pda_tpu_torch.train import step as ST

OPT = dict(weight_decay=0.05, beta1=0.9, beta2=0.999, max_grad_norm=1.0)


def _models():
    jm = JViT(patch_size=16, embed_dim=64, depth=2, num_heads=4, hidden=16,
              dropout=0.0)
    tm = TViT(embed_dim=64, depth=2, num_heads=4, hidden=16, img_size=32,
              dropout=0.0)
    return jm, tm


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            "label": np.array([0, 1, 1, 0][:b], np.int32)}


def _jax_and_port_states(ema_decay=None):
    jm, tm = _models()
    jtx = j_make_optimizer(j_sched(3e-4, 100), ema_decay=ema_decay, **OPT)
    jstate = j_create(jm, jtx, jax.random.PRNGKey(0),
                      input_shape=(1, 32, 32, 3))
    ttx = S.make_optimizer(ts.make_lr_schedule(3e-4, 100),
                           ema_decay=ema_decay, **OPT)
    tstate = S.create_train_state(
        tm, ttx, seed=0, variables={"params": jstate.params},
        apply_fn=make_apply(tm, dtype=torch.float32), device="cpu")
    return jstate, tstate


def _assert_tree_close(port_tree, jax_tree, key_bias_atol=None, **tol):
    leaves, paths = S.tree_flatten(port_tree)
    jflat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(leaves) == len(jflat)
    for leaf, path, (jpath, jleaf) in zip(leaves, paths, jflat):
        assert tuple(k.key for k in jpath) == path
        got, want = leaf.detach().numpy(), np.array(jleaf)
        if key_bias_atol is not None and path[-2:] == ("qkv", "bias"):
            keys = slice(got.size // 3, 2 * got.size // 3)
            np.testing.assert_allclose(got[keys], want[keys],
                                       atol=key_bias_atol, rtol=0,
                                       err_msg=str(path))
            got, want = np.delete(got, keys), np.delete(want, keys)
        np.testing.assert_allclose(got, want, err_msg=str(path), **tol)


@pytest.mark.parametrize("steps", [1, 2])
def test_train_step_matches_jax(steps):
    jstate, tstate = _jax_and_port_states(ema_decay=0.99)
    jstep = j_train_step(jl.make_loss_fn("focal"), donate=False)
    tstep = ST.make_train_step(tl.make_loss_fn("focal"))
    for i in range(steps):
        batch = _batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm_ = tstep(tstate, batch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
    assert tstate.step == int(jstate.step) == steps
    lr2 = 2 * 3e-4 * steps
    _assert_tree_close(tstate.params, jstate.params, key_bias_atol=lr2,
                       atol=1e-5, rtol=0)
    _assert_tree_close(S.find_ema_params(tstate),
                       j_find_ema(jstate.opt_state), key_bias_atol=lr2,
                       atol=1e-5, rtol=0)


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * scale).astype(np.float32),
                  "d": (rng.standard_normal((2, 2)) * scale).astype(
                      np.float32)}}


@pytest.mark.parametrize("accum,ema,clip", [(1, None, 1.0), (2, 0.9, 1.0),
                                            (3, None, None), (1, 0.5, 0.5)])
def test_optimizer_tracks_optax_on_identical_gradients(accum, ema, clip):
    """Six steps with gradient norms on both sides of the clip; params,
    EMA shadow and the update count after every step."""
    kw = dict(weight_decay=0.05, max_grad_norm=clip,
              gradient_accumulation_steps=accum, ema_decay=ema)
    jtx = j_make_optimizer(j_sched(1e-2, 10), **kw)
    ttx = S.make_optimizer(ts.make_lr_schedule(1e-2, 10), **kw)
    p0 = _grads(100, 1.0)
    jparams = jax.tree.map(jnp.asarray, p0)
    jopt = jtx.init(jparams)
    leaves, paths = S.tree_flatten(p0)
    tparams = [torch.tensor(a) for a in leaves]
    topt = ttx.init(tparams)
    for i in range(6):
        g = _grads(i, [0.05, 3.0][i % 2])
        updates, jopt = jtx.update(jax.tree.map(jnp.asarray, g), jopt,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        moved = ttx.update([torch.tensor(a) for a in S.tree_flatten(g)[0]],
                           topt, tparams)
        assert moved == ((i + 1) % accum == 0)
        _assert_tree_close(S.tree_unflatten(paths, tparams), jparams,
                           atol=1e-7, rtol=1e-6)
        if ema is not None:
            _assert_tree_close(S.tree_unflatten(paths, topt["ema"]),
                               j_find_ema(jopt), atol=1e-7, rtol=1e-6)
    assert topt["count"] == 6 // accum


def test_eval_step_matches_jax():
    jstate, tstate = _jax_and_port_states()
    jm, _ = _models()
    images = _batch(5)["image"]
    want = j_eval_step(jm.apply)(jstate.params, None, jnp.asarray(images))
    got = ST.make_eval_step(tstate.apply_fn)(tstate.params, images)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), atol=1e-4)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))


def test_step_generator_replays_by_seed_and_step():
    def draw(seed, step):
        return torch.rand(8, generator=ST.step_generator(seed, step, "cpu"))

    assert torch.equal(draw(3, 7), draw(3, 7))
    assert not torch.equal(draw(3, 7), draw(3, 8))
    assert not torch.equal(draw(3, 7), draw(4, 7))
    prep = torch.rand(8, generator=ST.step_generator(3, 7, "cpu", 104729))
    assert not torch.equal(prep, draw(3, 7))


def test_train_step_with_dropout_replays_after_resume():
    """Two states at the same seed and step take the same dropout masks,
    so a run restored at step k repeats step k exactly."""
    _, tm = _models()
    tm.dropout = 0.3
    batch = _batch(1)
    losses = []
    for _ in range(2):
        tx = S.make_optimizer(1e-3)
        st = S.create_train_state(tm, tx, seed=5, device="cpu",
                                  apply_fn=make_apply(tm,
                                                      dtype=torch.float32))
        st.step = 4
        _, met = ST.make_train_step(tl.make_loss_fn("focal"))(st, batch)
        losses.append(float(met["loss"]))
    assert losses[0] == losses[1]


def test_pool_batches_raise():
    """Pool batches (with ``index``) train since the pool gather landed
    (tests/test_torch_pool.py); an index outside the pool still raises,
    on the host, before the step runs anything."""
    _, tstate = _jax_and_port_states()
    batch = dict(_batch(0), index=np.array([0, 4], dtype=np.int32))
    with pytest.raises(IndexError, match="pool indices"):
        ST.make_train_step(tl.make_loss_fn("focal"))(tstate, batch)
    assert tstate.step == 0


def test_training_entry_points_need_a_card_unless_cpu(monkeypatch):
    _, tm = _models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.create_train_state(tm, S.make_optimizer(1e-3))
    st = S.create_train_state(tm, S.make_optimizer(1e-3), device="cpu")
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in st.leaves())
    assert all(p.dtype == torch.float32 for p in st.leaves())
