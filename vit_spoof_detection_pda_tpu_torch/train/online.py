"""Online differential augmentation feeding training (counterpart of the
JAX package's ``train/online.py``).

The raw manifest is expanded record-wise: each live record appears
``1 + live_mult`` times, each spoof ``1 + spoof_mult`` times, every copy
tagged with its severity tier (first third heavy, middle medium, rest
light); augmentation runs on the device inside the train step.  Batches
are grouped by tier, so each batch runs one chain; the groups' batch
streams interleave in a seeded order each epoch.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Sequence

import numpy as np

from ..augment.policy import severity_for_copy
from ..data.loader import DataPipeline
from ..data.manifest import Record

log = logging.getLogger(__name__)

GROUPS = ("orig", "heavy", "medium", "light")


def expand_records(records: Sequence[Record], live_mult: int,
                   spoof_mult: int) -> dict:
    """``{group: [Record, ...]}`` with the differential fan-out applied."""
    groups = {g: [] for g in GROUPS}
    for r in records:
        groups["orig"].append(r)
        n = live_mult if r.label == 1 else spoof_mult
        for i in range(n):
            groups[severity_for_copy(i, n)].append(r)
    return groups


class OnlineAugmentedData:
    """Epoch iterator over severity-homogeneous uint8 batches."""

    def __init__(self, records: Sequence[Record], *, live_mult: int = 8,
                 spoof_mult: int = 2, batch_size: int = 128,
                 img_size: int = 224, num_workers: int = 8,
                 prefetch_depth: int = 4, seed: int = 42):
        self.groups = expand_records(records, live_mult, spoof_mult)
        self.seed = seed
        active = {g: rs for g, rs in self.groups.items() if rs}
        # the decode budget is per run, shared by the group pipes
        per_workers = max(1, num_workers // max(len(active), 1))
        per_prefetch = max(1, prefetch_depth // max(len(active), 1))
        self.pipes = {}
        for j, (g, rs) in enumerate(active.items()):
            if len(rs) < batch_size:
                # a tier smaller than one batch would be dropped by
                # drop_last: wrap-pad it to one full batch
                log.warning(
                    "online group %r has %d records < batch_size %d — "
                    "wrap-padding to one full batch", g, len(rs),
                    batch_size)
                rs = [rs[i % len(rs)] for i in range(batch_size)]
            # 131071 * j: additive seeds would collide across (group, epoch)
            self.pipes[g] = DataPipeline(
                rs, batch_size=batch_size, img_size=img_size,
                resize="exact", num_workers=per_workers,
                prefetch_depth=per_prefetch, shuffle=True,
                drop_last=True, seed=seed + 131071 * (j + 1))

    @property
    def steps_per_epoch(self) -> int:
        return sum(p.steps_per_epoch for p in self.pipes.values())

    def batches(self, epoch: int, *, skip: int = 0) -> Iterator[tuple]:
        """Yield ``(group, {"image": u8, "label": i32, "index": i64})`` in a
        seeded interleaved order; ``skip`` drops the first ``skip``
        interleaved batches (each pipe skips its share before decoding)."""
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        order: List[str] = []
        for g, p in self.pipes.items():
            order.extend([g] * p.steps_per_epoch)
        np.random.default_rng(self.seed + 977 * epoch).shuffle(order)
        skip = min(skip, len(order))
        consumed = {g: order[:skip].count(g) for g in self.pipes}
        iters = {g: p.batches(epoch, skip=consumed[g])
                 for g, p in self.pipes.items()}
        for g in order[skip:]:
            try:
                yield g, next(iters[g])
            except StopIteration:  # pragma: no cover - drop_last guards
                continue
