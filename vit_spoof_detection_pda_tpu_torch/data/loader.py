"""Host decode + prefetch pipeline (counterpart of the JAX package's
``data/loader.py``).

The host does the minimum, decode and a fixed-size resize; augmentation
and normalization run on the device.  A thread pool decodes ahead through
a bounded queue, and :func:`prefetch_to_device` keeps batches in flight
on the card.  Corrupt files decode to a black image with a logged
warning.  Files decode through the native libjpeg/libpng codec
(``data/native``) first and through PIL where it declines, as in the
JAX package.  In a multi-rank run :func:`shard_for_host` gives each data
rank its equal share.

PIL is imported inside the functions, so the module imports where PIL
is not installed; only what the native codec declines needs it.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import io
import logging
import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np
import torch

from .manifest import Record

log = logging.getLogger(__name__)


def _pil_to_sized_rgb(im, size: int, resize: str) -> np.ndarray:
    """RGB-convert and resize an open PIL image to (size, size, 3) uint8.
    ``resize="exact"``: (size, size).  ``resize="shorter"``: the shorter
    side to ``size`` keeping the aspect ratio, then a center crop of the
    longer side to ``size``."""
    from PIL import Image

    im = im.convert("RGB")
    if resize == "exact":
        im = im.resize((size, size), Image.BILINEAR)
    else:
        w, h = im.size
        # half away from zero, like the native decoder's lround; Python's
        # round() rounds halves to even and would pick another grid
        if w <= h:
            nw, nh = size, max(1, int(h * size / w + 0.5))
        else:
            nw, nh = max(1, int(w * size / h + 0.5)), size
        im = im.resize((nw, nh), Image.BILINEAR)
        left = (nw - size) // 2
        top = (nh - size) // 2
        im = im.crop((left, top, left + size, top + size))
    return np.asarray(im, dtype=np.uint8)


def decode_image(path: str, size: int, resize: str = "exact") -> np.ndarray:
    """Decode a file to (size, size, 3) uint8 RGB (geometry as
    :func:`_pil_to_sized_rgb`); a black image on any decode failure.

    Fast path: the native codec (``data/native``: libjpeg's DCT-domain
    prescale and PIL's bilinear resample in C, the GIL released for the
    whole call).  PIL handles whatever the native path declines."""
    try:
        from .native import native_decode
        out = native_decode(path, size, resize)
        if out is not None:
            return out
    except Exception as e:                       # noqa: BLE001
        # the fallback contract covers the native path too: PIL gets its
        # turn, then the black frame
        log.warning("native decode raised for %s (%s) — PIL fallback",
                    path, e)
    from PIL import Image
    try:
        with Image.open(path) as im:
            return _pil_to_sized_rgb(im, size, resize)
    except Exception as e:                       # noqa: BLE001
        log.warning("decode failed for %s (%s) — black fallback", path, e)
        return np.zeros((size, size, 3), np.uint8)


def decode_image_bytes(data: bytes, size: int,
                       resize: str = "exact") -> np.ndarray:
    """Decode in-memory image bytes to (size, size, 3) uint8 RGB.  Raises
    ``ValueError`` on undecodable input: a scoring service rejects a
    corrupt upload rather than score a black frame."""
    from PIL import Image
    try:
        with Image.open(io.BytesIO(data)) as im:
            return _pil_to_sized_rgb(im, size, resize)
    except Exception as e:                       # noqa: BLE001
        raise ValueError(f"undecodable image bytes ({e})") from e


def shard_for_host(records: Sequence[Record], mesh=None) -> List[Record]:
    """This rank's share of the dataset in a multi-rank run (JAX :114):
    every rank gets EXACTLY ``n // ranks`` records, ``records[i::ranks]``
    (the tail remainder, fewer than ``ranks`` records, is dropped: a
    one-record skew would make the ranks' steps per epoch differ, and the
    rank with one more step would hang in its gradient all-reduce).  The
    ranks are the process group's, or with ``mesh`` its data axis (the
    ranks of one sequence group share their rows).  One rank: all of
    it."""
    from ..parallel import mesh as pmesh
    if mesh is not None:
        n, idx = (pmesh.axis_sizes(mesh).get(pmesh.DATA_AXIS, 1),
                  pmesh.axis_rank(mesh, pmesh.DATA_AXIS))
    else:
        n, idx = pmesh.world_size(), pmesh.rank()
    if n == 1:
        return list(records)
    per = len(records) // n
    if per == 0 and records:
        # every rank would get [] and die later inside the splitter with an
        # unrelated-looking error
        raise ValueError(
            f"dataset of {len(records)} records is smaller than the "
            f"{n}-rank data axis — nothing to shard")
    return list(records)[idx::n][:per]


def epoch_order(n: int, epoch: int, seed: int,
                shuffle: bool) -> np.ndarray:
    """The seeded per-epoch sample order."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def epoch_limit(n: int, batch_size: int, drop_last: bool) -> int:
    """Number of samples an epoch serves under the drop_last policy."""
    return (n // batch_size) * batch_size if drop_last else n


def steps_for(n: int, batch_size: int, drop_last: bool) -> int:
    return (epoch_limit(n, batch_size, drop_last)
            + batch_size - 1) // batch_size


class DataPipeline:
    """Threaded decode pipeline yielding uint8 batches; one epoch is one
    call to :meth:`batches`, shuffled from ``(seed, epoch)``."""

    def __init__(self, records: Sequence[Record], *, batch_size: int,
                 img_size: int = 224, resize: str = "exact",
                 num_workers: int = 8, prefetch_depth: int = 4,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 42):
        self.records = list(records)
        self.batch_size = batch_size
        self.img_size = img_size
        self.resize = resize
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

    @property
    def steps_per_epoch(self) -> int:
        return steps_for(len(self.records), self.batch_size,
                         self.drop_last)

    def batches(self, epoch: int = 0, *, skip: int = 0) -> Iterator[dict]:
        """Yield ``{"image": uint8 [B,S,S,3], "label": int32 [B], "index":
        int64 [B]}`` decoded in the background.  ``skip`` drops the first
        ``skip`` batches before decoding (mid-epoch resume)."""
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        order = epoch_order(len(self.records), epoch, self.seed, self.shuffle)
        limit = epoch_limit(len(order), self.batch_size, self.drop_last)
        starts = list(range(0, limit, self.batch_size))[skip:]
        if not starts:
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        err: list = []

        def _put(item) -> bool:
            """A put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with futures.ThreadPoolExecutor(self.num_workers) as pool:
                    for s in starts:
                        if stop.is_set():
                            break
                        idxs = order[s:s + self.batch_size]
                        imgs = list(pool.map(
                            lambda i: decode_image(
                                self.records[i].path, self.img_size,
                                self.resize), idxs))
                        labels = np.asarray(
                            [self.records[i].label for i in idxs], np.int32)
                        if not _put({"image": np.stack(imgs),
                                     "label": labels,
                                     "index": idxs.astype(np.int64)}):
                            break
            except BaseException as e:          # surfaced in the consumer
                err.append(e)
            finally:
                _put(None)                      # the sentinel always lands

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if err:
                        raise RuntimeError(
                            "decode producer failed") from err[0]
                    break
                yield item
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)


def prefetch_to_device(iterator, *, device=None, depth: int = 2):
    """Keep ``depth`` batches in flight on ``device`` (the card by
    default): every numpy array or tensor of a batch dict goes over with
    ``.to(device, non_blocking=True)``, from pinned memory on a card."""
    from ..device import resolve_device

    dev = resolve_device(device)

    def put(item):
        out = {}
        for k, v in item.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                if dev.type == "cuda" and v.device.type == "cpu":
                    v = v.pin_memory()
                v = v.to(dev, non_blocking=True)
            out[k] = v
        return out

    buf = collections.deque()
    for item in iterator:
        buf.append(put(item))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
