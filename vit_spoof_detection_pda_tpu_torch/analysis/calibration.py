"""Temperature scaling of P(live) scores (the port's copy of
``apply_temperature`` from the JAX package's ``analysis/calibration.py``;
the rest of that analyzer comes with a later slice)."""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def apply_temperature(scores, temperature: float):
    """Rescale probabilities through ``sigmoid(logit(p) / T)`` in float64
    (monotone — rankings, AUC and EER are invariant)."""
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    p = np.clip(np.asarray(scores, np.float64), _EPS, 1.0 - _EPS)
    z = (np.log(p) - np.log1p(-p)) / float(temperature)
    return 1.0 / (1.0 + np.exp(-z))
