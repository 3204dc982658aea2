"""Differential augmentation engine (counterpart of the JAX package's
``augment/``).

`policy.py`   severity-tier op chains (heavy / medium / light), the
              severity schedule, the differential live/spoof plan and
              the train-time chain.
`engine.py`   batched on-device augmentation: the offline materializer
              (JPEG files) and the online mode feeding training.
"""

from .policy import (
    heavy_chain, light_chain, medium_chain, severity_for_copy,
    differential_plan, make_batch_augmenter, train_time_chain,
)
from .engine import AugmentEngine  # noqa: F401

__all__ = [
    "heavy_chain", "medium_chain", "light_chain", "severity_for_copy",
    "differential_plan", "make_batch_augmenter", "train_time_chain",
    "AugmentEngine",
]
