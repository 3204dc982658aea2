"""The port's tensor metrics (metrics/device.py) against the JAX
package's on random, tied, single-class and n = 1 vectors.

Tolerances: counts, thresholds, ROC points and the validity mask equal;
f32 rates and AUC within 1e-6 (the sums run in other orders); NaN where
JAX gives NaN (single-class ROC rates)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.metrics import device as J
from vit_spoof_detection_pda_tpu_torch.metrics import device as T


def _cases():
    rng = np.random.default_rng(0)
    s = rng.random(200).astype(np.float32)
    y = rng.integers(0, 2, 200)
    tied = np.round(rng.random(120) * 8).astype(np.float32) / 8
    return {
        "random": (s, y),
        "tied": (tied, rng.integers(0, 2, 120)),
        "single_class": (s[:50], np.ones(50, np.int64)),
        "n1": (np.float32([0.7]), np.int64([1])),
        "all_equal": (np.full(30, 0.5, np.float32), rng.integers(0, 2, 30)),
    }


CASES = _cases()


def _close(got, want, exact=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_threshold_table_matches_jax(case):
    s, y = CASES[case]
    grid = np.linspace(0.0, 1.0, 21).astype(np.float32)
    want = J.threshold_table(jnp.asarray(s), jnp.asarray(y),
                             jnp.asarray(grid))
    got = T.threshold_table(torch.from_numpy(s), torch.from_numpy(y),
                            torch.from_numpy(grid))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], exact=k in ("tp", "tn", "fp", "fn",
                                            "threshold"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimal_threshold_f1_matches_jax(case):
    s, y = CASES[case]
    jt, jf, jtab = J.optimal_threshold_f1(jnp.asarray(s), jnp.asarray(y))
    tt, tf, ttab = T.optimal_threshold_f1(torch.from_numpy(s),
                                          torch.from_numpy(y))
    # the grids within one f32 ulp (T.threshold_grid); the chosen index and
    # its F1 equal
    np.testing.assert_array_max_ulp(ttab["threshold"].numpy(),
                                    np.asarray(jtab["threshold"]), 1)
    np.testing.assert_array_max_ulp(np.float32(tt), np.float32(jt), 1)
    _close(tf, jf)
    for k in ("tp", "fp"):
        _close(ttab[k], jtab[k], exact=True)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("drop", [True, False])
def test_masked_roc_matches_jax(case, drop):
    s, y = CASES[case]
    want = J.masked_roc(jnp.asarray(s), jnp.asarray(y),
                        drop_intermediate=drop)
    got = T.masked_roc(torch.from_numpy(s), torch.from_numpy(y),
                       drop_intermediate=drop)
    _close(got.valid, want.valid, exact=True)
    _close(got.thresholds, want.thresholds, exact=True)
    for k in ("fpr", "tpr"):
        _close(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_auc_and_eers_match_jax(case):
    s, y = CASES[case]
    js, jy = jnp.asarray(s), jnp.asarray(y)
    ts, ty = torch.from_numpy(s), torch.from_numpy(y)
    _close(T.auc(ts, ty), J.auc(js, jy))
    _close(T.eer_mean(ts, ty), J.eer_mean(js, jy))
    for g, w in zip(T.eer_harness(ts, ty), J.eer_harness(js, jy)):
        _close(g, w)


def test_binary_metrics_zero_division():
    got = T.binary_metrics_from_counts(0, 0, 0, 0)
    want = J.binary_metrics_from_counts(0, 0, 0, 0)
    for k in want:
        _close(got[k], want[k], exact=True)


def test_threshold_grid_is_the_rounded_float64_linspace():
    g = T.threshold_grid(0.3, 0.7, 41)
    assert g.dtype == torch.float32 and g.shape == (41,)
    np.testing.assert_array_equal(
        g.numpy(), np.linspace(0.3, 0.7, 41).astype(np.float32))
    np.testing.assert_array_max_ulp(g.numpy(),
                                    np.asarray(jnp.linspace(0.3, 0.7, 41)), 1)
