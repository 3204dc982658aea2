"""The port's sweep driver (``train/sweep.py``, without JAX) against the
JAX package's: for the same seed and a deterministic objective,
``run_sweep`` proposes the same overrides in the same order (bayes and
random_exploit, 8 trials), and ``_gp_ei`` — whose erf JAX computes at f32
with x64 off, the port with ``torch.special.erf`` on f32 — agrees within
1e-6 and picks the same candidate."""

import math

import numpy as np
import pytest

from vit_spoof_detection_pda_tpu.config import Config as JConfig
from vit_spoof_detection_pda_tpu.train import sweep as jsweep
from vit_spoof_detection_pda_tpu_torch.config import Config as TConfig
from vit_spoof_detection_pda_tpu_torch.train import sweep as tsweep


def _objective(cfg):
    """A smooth, deterministic stand-in for a training run's metrics."""
    lr = cfg.optim.learning_rate
    score = (1.0 - (math.log(lr) - math.log(1.5e-4)) ** 2 / 10
             - abs(cfg.model.dropout - 0.1)
             + (0.05 if cfg.loss.loss_type == "focal" else 0.0)
             - 0.001 * abs(cfg.data.batch_size - 128)
             - abs(math.log(cfg.optim.weight_decay) - math.log(0.03)) / 20
             - abs(cfg.loss.focal_gamma - 2.0) / 10)
    return {"optimal_f1": score, "val_f1": score}


@pytest.mark.parametrize("method", ["bayes", "random_exploit"])
def test_run_sweep_proposes_the_same_trials(method, tmp_path):
    kw = dict(count=8, seed=3, method=method)
    base = {"checkpoint.save_dir": str(tmp_path)}
    jres = jsweep.run_sweep(JConfig().with_overrides(base), _objective, **kw)
    tres = tsweep.run_sweep(TConfig().with_overrides(base), _objective, **kw)
    order = lambda res: sorted(res, key=lambda r: r.run_index)  # noqa: E731
    assert [r.overrides for r in order(tres)] == [
        r.overrides for r in order(jres)]
    assert [r.metric for r in tres] == [r.metric for r in jres]
    assert [r.run_index for r in tres] == [r.run_index for r in jres]


def test_gp_ei_matches_jax():
    rng = np.random.default_rng(0)
    for n in (2, 4, 7, 11):
        x_seen = rng.random((n, 11))
        y_seen = rng.random(n)
        x_cand = rng.random((512, 11))
        want = np.asarray(jsweep._gp_ei(x_seen, y_seen, x_cand))
        got = tsweep._gp_ei(x_seen, y_seen, x_cand)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert int(np.argmax(got)) == int(np.argmax(want))


def test_sweep_space_and_wandb_parameters_match_jax():
    assert tsweep.DEFAULT_SPACE == jsweep.DEFAULT_SPACE
    assert (tsweep._wandb_parameters(tsweep.DEFAULT_SPACE)
            == jsweep._wandb_parameters(jsweep.DEFAULT_SPACE))


def test_missing_metric_raises(tmp_path):
    cfg = TConfig().with_overrides({"checkpoint.save_dir": str(tmp_path)})
    with pytest.raises(KeyError, match="sweep metric"):
        tsweep.run_sweep(cfg, lambda c: {"val_f1": 0.5}, count=1)
