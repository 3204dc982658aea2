"""LR schedules (counterpart of the JAX package's ``train/schedule.py``).

The reference computes ``warmup_steps`` but never ramps: its
CosineAnnealingLR runs with ``T_max = total - warmup`` from full LR at
step 0, and torch's cosine curves back up past ``T_max``.
``true_warmup=False`` keeps that quirk; ``true_warmup=True`` gives a
linear ramp and then a cosine decay clamped at ``min_lr``.  Both compute
in float32, as the JAX schedule does.
"""

from __future__ import annotations

import numpy as np


def make_lr_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                     min_lr: float = 1e-6, true_warmup: bool = False):
    """``step -> lr`` (a float32 scalar)."""
    f = np.float32
    if true_warmup and warmup_steps > 0:
        decay_steps = max(total_steps - warmup_steps, 1)

        def sched(step):
            step = f(step)
            if step < warmup_steps:
                return f(base_lr) * step / f(warmup_steps)
            t = np.clip((step - f(warmup_steps)) / f(decay_steps), f(0), f(1))
            return f(min_lr) + f(base_lr - min_lr) * f(0.5) * (
                f(1) + np.cos(f(np.pi) * t))

        return sched

    t_max = max(total_steps - warmup_steps, 1)

    def sched(step):
        return f(min_lr) + f(base_lr - min_lr) * f(0.5) * (
            f(1) + np.cos(f(np.pi) * f(step) / f(t_max)))

    return sched
