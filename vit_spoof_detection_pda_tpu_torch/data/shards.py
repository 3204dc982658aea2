"""Pre-decoded uint8 shard store (counterpart of the JAX package's
``data/shards.py``): decode the training set once, feed every epoch from
memory-mapped arrays.

The reference re-decodes all ~115k JPEGs every epoch through 28
DataLoader workers (train_advanced.py:554-573).  Here a one-time decode
pass writes ``images-NNNNN.npy`` shards (uint8, the pipeline's resize
applied) plus a ``shards.json`` index; epochs then gather shuffled
batches straight from the memmaps: no decode, no worker pool, I/O
bounded by the page cache instead of the CPU.

Layout of ``<dir>/shards.json``::

    {"n": 115125, "img_size": 256, "resize": "shorter", "digest": ...,
     "shards": [{"file": ..., "n": ...}], "labels": [...]}

The files are the bytes the JAX package's ``ShardStore.build`` writes for
the same records, so a store either package built is reused by the
other.  ``ShardStore.build`` is idempotent: an existing store matching
the record list (count + sha1 over every path and label + size + resize)
whose shard files are whole is reused, not rebuilt.  Images decode
through ``data/loader.py::decode_image`` (the native codec, else PIL),
looked up at call time.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from . import loader
from .manifest import Record

log = logging.getLogger(__name__)

MANIFEST = "shards.json"


class ShardStore:
    def __init__(self, directory: str):
        self.dir = Path(directory)
        with open(self.dir / MANIFEST) as f:
            self.meta = json.load(f)
        self.labels = np.asarray(self.meta["labels"], np.int32)
        self._mm = None     # lazy memmaps (fork-safety: open per process)
        self._starts = np.cumsum(
            [0] + [s["n"] for s in self.meta["shards"]])

    # -- construction -------------------------------------------------------

    @staticmethod
    def _fingerprint(records, img_size, resize):
        # the digest covers EVERY path and label, not just the endpoints:
        # moving or relabeling a middle record must invalidate the cache
        h = hashlib.sha1()
        for r in records:
            h.update(f"{r.path}\t{r.label}\n".encode())
        return {"n": len(records), "img_size": img_size, "resize": resize,
                "digest": h.hexdigest()}

    @classmethod
    def _manifest_matches(cls, d: Path, fp: dict):
        """True/False: the manifest's fingerprint against ``fp``; None
        when no readable manifest exists (a crashed or unfinished
        build)."""
        try:
            with open(d / MANIFEST) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return all(meta.get(k) == v for k, v in fp.items())

    @classmethod
    def _try_reuse(cls, d: Path, fp: dict):
        """The up-to-date store at ``d``, or None."""
        if not (d / MANIFEST).exists():
            return None
        try:
            store = cls(str(d))
            if (all(store.meta.get(k) == v for k, v in fp.items())
                    and store._shards_intact()):
                log.info("shard store up to date: %s (%d images)",
                         d, len(store))
                return store
        except Exception:       # noqa: BLE001 — a corrupt store: rebuild
            pass
        return None

    @classmethod
    def build(cls, records: Sequence[Record], directory: str, *,
              img_size: int, resize: str = "shorter",
              shard_size: int = 2048, num_workers: int = 8,
              build_timeout: float = 3600.0) -> "ShardStore":
        """Decode ``records`` into shards under ``directory`` (reused if
        an up-to-date store already exists).

        Concurrent builds of the SAME store (ranks on a shared filesystem)
        are serialized by an ``O_EXCL`` lock file: one process builds,
        the others adopt its manifest.  A lock older than
        ``build_timeout`` seconds (its holder heartbeats it after every
        shard) is stolen by an atomic rename.  Two processes with
        DIFFERENT record lists on one directory is a configuration error
        and raises (their alternating rebuilds would feed each other's
        live memmaps garbage); the training driver gives each rank its
        own subdirectory."""
        records = list(records)
        d = Path(directory)
        fp = cls._fingerprint(records, img_size, resize)
        store = cls._try_reuse(d, fp)
        if store is not None:
            return store
        d.mkdir(parents=True, exist_ok=True)
        lock = d / ".building.lock"
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                break
            except FileExistsError:
                try:
                    stale = (time.time() - lock.stat().st_mtime
                             > build_timeout)
                except OSError:
                    continue    # the holder just released it: retry
                if stale:
                    # the rename succeeds for exactly ONE stealer; the
                    # others loop back to the wait
                    try:
                        grave = d / f".building.lock.stale.{os.getpid()}"
                        lock.rename(grave)
                        grave.unlink()
                        log.warning("stole stale shard-store lock %s",
                                    lock)
                    except OSError:
                        pass
                    continue
                time.sleep(0.2)
                if not lock.exists():
                    # the holder released the lock: adopt its store if it
                    # is ours.  A manifest with a DIFFERENT fingerprint is
                    # the configuration error; no (or a corrupt) manifest
                    # means the holder crashed mid-build: build it here
                    store = cls._try_reuse(d, fp)
                    if store is not None:
                        return store
                    if cls._manifest_matches(d, fp) is False:
                        raise RuntimeError(
                            f"shard store at {d} was concurrently built "
                            "with a DIFFERENT record list/params — point "
                            "each writer at its own cache directory")
                    continue
        try:
            # re-check under the lock: another process may have finished
            # the build while this one waited
            store = cls._try_reuse(d, fp)
            if store is not None:
                return store
            return cls._build_locked(records, d, fp, img_size=img_size,
                                     resize=resize, shard_size=shard_size,
                                     num_workers=num_workers, lock=lock)
        finally:
            lock.unlink(missing_ok=True)

    @classmethod
    def _build_locked(cls, records, d: Path, fp: dict, *, img_size: int,
                      resize: str, shard_size: int,
                      num_workers: int, lock: Path = None) -> "ShardStore":
        if (d / MANIFEST).exists():
            log.info("shard store stale — rebuilding %s", d)
            # drop the old manifest FIRST: an interrupted rebuild must
            # leave an invalid store, not shard files that match the
            # previous fingerprint
            (d / MANIFEST).unlink()

        shards = []
        with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
            for si in range(0, len(records), shard_size):
                chunk = records[si:si + shard_size]
                name = f"images-{si // shard_size:05d}.npy"
                arr = np.lib.format.open_memmap(
                    d / name, mode="w+", dtype=np.uint8,
                    shape=(len(chunk), img_size, img_size, 3))
                for j, img in enumerate(pool.map(
                        lambda r: loader.decode_image(r.path, img_size,
                                                      resize), chunk)):
                    arr[j] = img
                arr.flush()
                del arr
                shards.append({"file": name, "n": len(chunk)})
                if lock is not None:
                    # heartbeat: staleness is judged by the lock's mtime,
                    # so a slow build must not look stale mid-write
                    lock.touch()
        # no per-record path list: the digest covers the paths, and at
        # ~115k images the list is megabytes parsed on every open
        meta = {**fp, "shards": shards,
                "labels": [int(r.label) for r in records]}
        with open(d / MANIFEST, "w") as f:
            json.dump(meta, f)
        # a rebuild with fewer records leaves higher-numbered shard files
        # of the previous build, unreferenced: remove what the manifest
        # does not own
        referenced = {s["file"] for s in shards}
        for orphan in d.glob("images-*.npy"):
            if orphan.name not in referenced:
                log.info("removing orphaned shard file %s", orphan)
                orphan.unlink()
        log.info("shard store built: %s (%d images, %d shards)", d,
                 len(records), len(shards))
        return cls(str(d))

    def _shards_intact(self) -> bool:
        """True iff every shard file of the manifest exists, has the
        expected ``.npy`` shape in its header and holds all its data
        bytes: memmaps are lazy, so a deleted or truncated shard would
        otherwise pass the reuse check and fail mid-epoch."""
        s = self.img_size
        for sh in self.meta["shards"]:
            p = self.dir / sh["file"]
            try:
                with open(p, "rb") as f:
                    version = np.lib.format.read_magic(f)
                    reader = getattr(
                        np.lib.format,
                        "read_array_header_%d_%d" % version)
                    shape, _, dtype = reader(f)
                    data_start = f.tell()
                ok = (shape == (sh["n"], s, s, 3) and dtype == np.uint8
                      and p.stat().st_size >= data_start + int(
                          np.prod(shape)))
            except Exception:   # noqa: BLE001 — unreadable = corrupt
                ok = False
            if not ok:
                log.warning("shard file missing/truncated: %s", p)
                return False
        return True

    # -- access -------------------------------------------------------------

    def __len__(self) -> int:
        return int(self.meta["n"])

    def _maps(self):
        if self._mm is None:
            self._mm = [np.load(self.dir / s["file"], mmap_mode="r")
                        for s in self.meta["shards"]]
        return self._mm

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """uint8 ``[len(indices), S, S, 3]`` in the given order."""
        indices = np.asarray(indices)
        maps = self._maps()
        out = np.empty((len(indices),) + maps[0].shape[1:], np.uint8)
        shard_of = np.searchsorted(self._starts, indices, "right") - 1
        for si in np.unique(shard_of):
            sel = np.nonzero(shard_of == si)[0]
            out[sel] = maps[si][indices[sel] - self._starts[si]]
        return out

    @property
    def img_size(self) -> int:
        return int(self.meta["img_size"])

    def steps_per_epoch(self, batch_size: int,
                        drop_last: bool = True) -> int:
        return loader.steps_for(len(self), batch_size, drop_last)

    def batches(self, batch_size: int, *, epoch: int = 0,
                shuffle: bool = True, seed: int = 42,
                drop_last: bool = True, skip: int = 0) -> Iterator[dict]:
        """Yield ``{"image": uint8 [B, S, S, 3], "label": int32 [B],
        "index": int64 [B]}``, the ``DataPipeline`` batch contract, from
        the memmaps with the same seeded per-epoch order
        (``loader.epoch_order`` / ``epoch_limit``).  ``skip`` drops the
        first ``skip`` batches (mid-epoch resume)."""
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        order = loader.epoch_order(len(self), epoch, seed, shuffle)
        limit = loader.epoch_limit(len(order), batch_size, drop_last)
        for i in range(skip * batch_size, limit, batch_size):
            idx = order[i:i + batch_size]
            yield {"image": self.gather(idx), "label": self.labels[idx],
                   "index": idx.astype(np.int64)}
