"""Device-resident training pool: the original images staged on the card
once, the epoch fed as index streams (counterpart of the JAX package's
``train/pool.py``).

Each step ships a ``[B]`` index vector; ``make_train_step`` gathers the
rows on the card (``ops/gather.py::pool_gather``, kernel 14), then
augments and trains.  The differential fan-out becomes index
replication, with the epoch order and severity assignment of
``OnlineAugmentedData`` (same expansion, same seeded shuffles).

The pool stays NHWC uint8: the JAX package's lane-packed ``[N, row //
128, 128]`` staging is a TPU tiling device, so :attr:`packed` is always
False and :meth:`wrap_prep` returns the prep unchanged.
"""

from __future__ import annotations

import logging
from typing import Iterator, Sequence

import numpy as np
import torch

from ..augment.policy import severity_for_copy
from ..data.loader import epoch_limit, epoch_order
from ..device import resolve_device
from .online import GROUPS

log = logging.getLogger(__name__)

_CHUNK_BYTES = 256 * 2 ** 20        # host -> card staging chunk


def expand_indices(labels: Sequence[int], live_mult: int,
                   spoof_mult: int) -> dict:
    """``{group: int32 pool-index array}`` with the differential fan-out
    applied (the index-space mirror of ``online.expand_records``;
    canonical labels, 1 = live)."""
    groups = {g: [] for g in GROUPS}
    for i, lbl in enumerate(labels):
        groups["orig"].append(i)
        n = live_mult if lbl == 1 else spoof_mult
        for c in range(n):
            groups[severity_for_copy(c, n)].append(i)
    return {g: np.asarray(ix, np.int32) for g, ix in groups.items()}


class DevicePoolData:
    """Epoch iterator over severity-homogeneous index batches into a pool
    on ``device`` (the card unless ``device="cpu"``).

    ``images``: the unique originals, uint8 ``[N, S, S, 3]`` (numpy, or a
    tensor); staged in chunks of at most 256 MB.  ``labels``: canonical
    labels (1 = live).  Batches carry the pool as their ``image`` plus
    host ``index`` / ``label`` vectors and the ``group``."""

    packed = False

    def __init__(self, images, labels, *, live_mult: int = 8,
                 spoof_mult: int = 2, batch_size: int = 128,
                 seed: int = 42, device=None):
        labels = np.asarray(labels, np.int32)
        if len(labels) != len(images):
            raise ValueError(
                f"labels ({len(labels)}) / images ({len(images)}) "
                "length mismatch")
        self.labels = labels
        self.batch_size = batch_size
        self.seed = seed
        self.group_indices = {
            g: ix for g, ix in expand_indices(
                labels, live_mult, spoof_mult).items() if len(ix)}
        for g, ix in self.group_indices.items():
            if len(ix) < batch_size:
                # the OnlineAugmentedData contract: wrap-pad, never drop
                log.warning(
                    "pool group %r has %d records < batch_size %d — "
                    "wrap-padding to one full batch", g, len(ix),
                    batch_size)
                self.group_indices[g] = ix[np.arange(batch_size) % len(ix)]

        dev = resolve_device(device)
        self.row_shape = tuple(images.shape[1:])
        if isinstance(images, torch.Tensor):
            self.pool = images.to(dev).contiguous()
        else:
            images = np.asarray(images)
            self.pool = torch.empty(images.shape, device=dev,
                                    dtype=torch.from_numpy(images[:0]).dtype)
            row = max(1, int(np.prod(self.row_shape)) * images.itemsize)
            chunk = max(1, _CHUNK_BYTES // row)
            for i in range(0, len(images), chunk):
                self.pool[i:i + chunk].copy_(
                    torch.from_numpy(np.ascontiguousarray(
                        images[i:i + chunk])))
        log.info("device pool staged: %d images, %.2f GB on %s",
                 len(labels), self.pool.numel() * self.pool.element_size()
                 / 2 ** 30, dev)

    def wrap_prep(self, prep):
        """The JAX package unpacked lane-packed rows here; the port's pool
        is NHWC, so ``prep`` comes back as it is."""
        return prep

    @property
    def steps_per_epoch(self) -> int:
        return sum(len(ix) // self.batch_size
                   for ix in self.group_indices.values())

    def batches(self, epoch: int, *, skip: int = 0) -> Iterator[dict]:
        """Seeded interleave of per-group index batches (per-epoch group
        order and per-group permutations independently seeded); ``skip``
        drops the first ``skip`` interleaved batches."""
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        B = self.batch_size
        order = []
        for g, ix in self.group_indices.items():
            order.extend([g] * (len(ix) // B))
        np.random.default_rng(self.seed + 977 * epoch).shuffle(order)

        cursors, perms = {}, {}
        for j, (g, ix) in enumerate(self.group_indices.items()):
            perm = epoch_order(len(ix), epoch, self.seed + 131071 * (j + 1),
                               shuffle=True)
            limit = epoch_limit(len(perm), B, drop_last=True)
            perms[g] = ix[perm[:limit]]
            cursors[g] = 0
        for g in order[:skip]:
            cursors[g] += B
        for g in order[skip:]:
            i = cursors[g]
            cursors[g] = i + B
            idx = perms[g][i:i + B]
            yield {"image": self.pool, "index": idx,
                   "label": self.labels[idx], "group": g}
