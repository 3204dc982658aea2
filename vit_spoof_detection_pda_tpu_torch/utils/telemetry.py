"""Structured metric stream (the port's copy of the JAX package's
``utils/telemetry.py``).

Replaces the reference's W&B logging (train_advanced.py:354-363, 411-463)
with a JSONL + console stream using the SAME key names (train/loss,
train/acc, train/lr, val/f1, val/auc, val/optimal_threshold, ...), so
existing dashboards stay comparable.  W&B is an optional sink, used when
the ``wandb`` package imports.

All values arrive as (possibly device) scalars; fetching happens here —
once per log call, never inside the train step.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Mapping, Optional

import numpy as np

log = logging.getLogger(__name__)


def _to_py(v):
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 wandb_entity: Optional[str] = None,
                 config: Optional[dict] = None,
                 echo: bool = True):
        self.jsonl_path = jsonl_path
        self.echo = echo
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._wandb = None
        self.run_id = f"local_{int(time.time())}"
        if wandb_project:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project,
                                         entity=wandb_entity, config=config)
                self.run_id = self._wandb.id
            except ImportError:
                log.info("wandb not installed; metrics go to JSONL/console")
            except Exception as e:              # noqa: BLE001
                # wandb is an OPTIONAL sink: an offline host or missing
                # auth (CommError/UsageError) must not abort training
                log.warning("wandb.init failed (%s); metrics go to "
                            "JSONL/console", e)

    def log(self, metrics: Mapping, step: Optional[int] = None):
        record = {k: _to_py(v) for k, v in metrics.items()}
        if step is not None:
            record["step"] = int(step)
        record["ts"] = time.time()
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(record, step=step)
        if self.echo:
            shown = {k: (round(v, 5) if isinstance(v, float) else v)
                     for k, v in record.items() if k != "ts"}
            log.info("metrics %s", shown)
        return record

    def close(self):
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()
