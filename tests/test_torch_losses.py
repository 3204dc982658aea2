"""The port's losses and LR schedule against the JAX package's, on the
same numpy-seeded logits and labels.

Tolerance: 1e-6 relative / 1e-7 absolute.  Both sides compute in f32 the
same formulas (log-softmax, the smoothed and weighted targets, the focal
factor, the cosine), so they differ only by the order of a few f32 sums
and by the libraries' exp, log and cos, a few f32 ulps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.ops import losses as jl
from vit_spoof_detection_pda_tpu.train import schedule as js
from vit_spoof_detection_pda_tpu_torch.ops import losses as tl
from vit_spoof_detection_pda_tpu_torch.train import schedule as ts

RTOL, ATOL = 1e-6, 1e-7


def _logits_labels(seed, b=16, c=2, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, c)) * scale).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    return logits, labels


def _both(fn_j, fn_t, logits, labels, **kw):
    want = np.asarray(fn_j(jnp.asarray(logits), jnp.asarray(labels), **kw))
    got = fn_t(torch.tensor(logits), torch.tensor(labels), **kw).numpy()
    return got, want


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weights", [None, (0.7, 2.5)])
def test_cross_entropy_matches_jax(reduction, smoothing, weights):
    logits, labels = _logits_labels(0, c=2)
    kw = dict(reduction=reduction, label_smoothing=smoothing)
    want = np.asarray(jl.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        class_weights=None if weights is None else jnp.asarray(weights),
        **kw))
    got = tl.cross_entropy(
        torch.tensor(logits), torch.tensor(labels),
        class_weights=None if weights is None else torch.tensor(weights),
        **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cross_entropy_many_classes_and_bf16_logits():
    logits, labels = _logits_labels(1, b=9, c=5)
    want = np.asarray(jl.cross_entropy(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
        label_smoothing=0.2))
    got = tl.cross_entropy(torch.tensor(logits).bfloat16(),
                           torch.tensor(labels), label_smoothing=0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 1.0)])
def test_focal_loss_matches_jax(reduction, alpha, gamma):
    logits, labels = _logits_labels(2)
    got, want = _both(jl.focal_loss, tl.focal_loss, logits, labels,
                      alpha=alpha, gamma=gamma, reduction=reduction)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_invalid_reduction_raises_on_both():
    logits, labels = _logits_labels(3)
    with pytest.raises(ValueError, match="reduction"):
        jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                         reduction="avg")
    with pytest.raises(ValueError, match="reduction"):
        tl.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                         reduction="avg")


@pytest.mark.parametrize("counts", [(30, 70), (0, 12), (5, 5, 10)])
def test_class_weights_from_counts_matches_jax(counts):
    np.testing.assert_allclose(
        tl.class_weights_from_counts(counts).numpy(),
        np.asarray(jl.class_weights_from_counts(counts)), rtol=RTOL)


@pytest.mark.parametrize("loss_type", ["focal", "weighted_ce", "ce"])
def test_make_loss_fn_matches_jax(loss_type):
    logits, labels = _logits_labels(4)
    kw = dict(focal_alpha=0.3, focal_gamma=1.5, label_smoothing=0.05,
              class_weights=(1.2, 0.8))
    want = np.asarray(jl.make_loss_fn(loss_type, **kw)(
        jnp.asarray(logits), jnp.asarray(labels)))
    got = tl.make_loss_fn(loss_type, **kw)(
        torch.tensor(logits), torch.tensor(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_make_loss_fn_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="class_weights"):
        tl.make_loss_fn("weighted_ce")
    with pytest.raises(ValueError, match="unknown loss_type"):
        tl.make_loss_fn("hinge")


@pytest.mark.parametrize("true_warmup", [False, True])
@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_matches_jax_past_t_max(true_warmup, warmup):
    """Every step up to twice the horizon: the no-warmup quirk's cosine
    curves back up past T_max on both sides."""
    kw = dict(base_lr=3e-4, total_steps=50, warmup_steps=warmup,
              min_lr=1e-6, true_warmup=true_warmup)
    sj, st = js.make_lr_schedule(**kw), ts.make_lr_schedule(**kw)
    steps = range(0, 101)
    want = np.array([float(sj(s)) for s in steps], np.float32)
    got = np.array([float(st(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    if not true_warmup:
        t_max = 50 - warmup
        assert got[t_max] == pytest.approx(1e-6, rel=1e-3)
        assert got[t_max + 10] > got[t_max]          # the cosine turns up
