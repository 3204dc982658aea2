"""The port's copy of ``metrics/parity.py`` against the JAX package's on
random, tied, single-class and n = 1 vectors: equal bit for bit (both
are the same float64 numpy arithmetic), NaN where the other is NaN."""

import warnings

import numpy as np
import pytest

from vit_spoof_detection_pda_tpu.metrics import parity as jp
from vit_spoof_detection_pda_tpu_torch.metrics import parity as tp


def _cases():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 200)
    return {
        "random": (y, rng.random(200)),
        "random_f32": (y, rng.random(200).astype(np.float32)),
        "tied": (y, np.round(rng.random(200), 1)),
        "all_tied": (y, np.full(200, 0.5)),
        "single_class": (np.ones(50, np.int64), rng.random(50)),
        "n1": (np.array([1]), np.array([0.7])),
        "n1_spoof": (np.array([0]), np.array([0.2])),
        "separable": (np.r_[np.zeros(10), np.ones(10)].astype(int),
                      np.r_[np.linspace(0, .4, 10), np.linspace(.6, 1, 10)]),
    }


CASES = _cases()


def _equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert type(a) is type(b) or np.asarray(a).dtype == np.asarray(b).dtype


def _both(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        try:
            want = getattr(jp, fn)(*args)
        except Exception as e:                   # noqa: BLE001
            with pytest.raises(type(e)):
                getattr(tp, fn)(*args)
            return
        got = getattr(tp, fn)(*args)
    _equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fn", ["np_roc_curve", "np_roc_auc_score",
                                "find_eer_threshold"])
def test_curve_functions_equal(case, fn):
    _both(fn, *CASES[case])


@pytest.mark.parametrize("case", list(CASES))
def test_calculate_metrics_equal(case):
    y, s = CASES[case]
    _both("calculate_metrics", y, (s > 0.5).astype(int), s)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("t", [0.1, 0.5, 0.7, 0.9])
def test_threshold_rows_equal(case, t):
    _both("calculate_metrics_at_threshold", *CASES[case], t)


def test_auc_trapezoid_direction_and_error():
    _both("np_auc_trapezoid", [0, .5, 1], [0, .8, 1])
    _both("np_auc_trapezoid", [1, .5, 0], [1, .8, 0])
    _both("np_auc_trapezoid", [0, 1, .5], [0, 1, 1])
