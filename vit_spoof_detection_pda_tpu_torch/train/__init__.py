"""Training of the port.

`schedule.py`   — the LR schedule.
`state.py`      — the optimizer chain (clip, AdamW, EMA, accumulation) and
                  the train state, updated in place.
`step.py`       — the train and eval steps (pool batches gathered on the
                  card).
`online.py`     — the online differential fan-out over decoded batches.
`pool.py`       — the device-resident image pool and its index streams.
`early_stop.py` — patience-based early stopping.
`trainer.py`    — :class:`Trainer`: fit, validation with the threshold
                  sweep, EMA, checkpoints, preemption, exact resume.
`driver.py`     — the in-step augmentation preps and
                  :func:`train_from_config`.
"""

from .driver import train_from_config  # noqa: F401
from .early_stop import EarlyStopping  # noqa: F401
from .schedule import make_lr_schedule  # noqa: F401
from .state import (TrainState, create_train_state,  # noqa: F401
                    make_optimizer)
from .step import make_eval_step, make_train_step  # noqa: F401
from .trainer import Trainer  # noqa: F401
