"""On-device differential augmentation engine (counterpart of the JAX
package's ``augment/engine.py``).

The copy fan-out of a batch stays on the device (augment -> clamp ->
uint8); only finished uint8 batches cross to the host, where a thread
pool JPEG-encodes while the device works on the next batch.  Online mode
skips the disk and feeds training.

The engine holds one ``torch.Generator`` on its device, seeded from
``seed`` and advanced by every call (the JAX engine's ``fold_in(key,
counter)``).  PIL is imported inside the functions that write or read
files, so the module imports where PIL is not installed.
"""

from __future__ import annotations

import concurrent.futures as futures
import logging
from pathlib import Path
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import image as I
from .policy import CHAINS, make_batch_augmenter, severity_for_copy

log = logging.getLogger(__name__)


class AugmentEngine:
    """Severity-tier augmenters + the differential fan-out, on ``device``
    (the card unless ``device="cpu"``)."""

    def __init__(self, live_augmentations: int = 8,
                 spoof_augmentations: int = 2, img_size: int = 224,
                 seed: int = 0, *, device=None):
        self.multipliers = {"live": live_augmentations,
                            "spoof": spoof_augmentations}
        self.img_size = img_size
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._augmenters = {lvl: make_batch_augmenter(lvl) for lvl in CHAINS}

    def augment_copies(self, batch01, class_name: str
                       ) -> Iterator[Tuple[int, str, torch.Tensor]]:
        """Yield ``(copy_index, severity, augmented [B,H,W,C])`` for the
        class's multiplier (live x8 / spoof x2).  ``batch01`` is float in
        [0, 1]; the copies are not clamped (noise and the normalized-domain
        jitter leave [0, 1]; the writeback clamps)."""
        if tuple(batch01.shape[1:3]) != (self.img_size, self.img_size):
            raise ValueError(
                f"batch is {batch01.shape[1]}x{batch01.shape[2]} but the "
                f"engine was built for img_size={self.img_size}")
        batch01 = torch.as_tensor(batch01).to(self.device)
        n = self.multipliers[class_name]
        for aug_idx in range(n):
            level = severity_for_copy(aug_idx, n)
            yield aug_idx, level, self._augmenters[level](self.generator,
                                                          batch01)

    def materialize(self, batches: Iterable[Tuple[list, np.ndarray]],
                    output_dir: str, class_name: str, *,
                    quality: int = 95, copy_originals: bool = True,
                    encode_workers: int = 8) -> int:
        """Offline mode: write ``{stem}_aug{i}.jpg`` (and ``{stem}_orig.jpg``)
        into ``output_dir/class_name/``; returns the count written.

        ``batches``: ``(paths, uint8 [B, S, S, 3])`` from the data layer.
        Names key on the path stem, so duplicate stems across input
        directories overwrite each other: a collision is logged as an
        error."""
        out_dir = Path(output_dir) / class_name
        out_dir.mkdir(parents=True, exist_ok=True)
        saved = 0
        seen_stems: dict = {}
        # bounded window of pending encodes: a fast device would otherwise
        # queue the whole output in host memory
        max_pending = max(encode_workers * 64, 256)
        with futures.ThreadPoolExecutor(encode_workers) as pool:
            jobs: list = []

            def drain(limit):
                nonlocal saved
                while len(jobs) > limit:
                    saved += jobs.pop(0).result()

            for paths, u8 in batches:
                for p in paths:
                    stem = Path(p).stem
                    prev = seen_stems.setdefault(stem, p)
                    if prev != p:
                        log.error(
                            "stem collision: %s and %s both write %s_*.jpg"
                            " — the later encode overwrites the earlier"
                            " (rename inputs or flatten the tree)",
                            prev, p, stem)
                u8 = np.asarray(u8)
                batch01 = I.to_float(torch.from_numpy(u8).to(self.device))
                if copy_originals:
                    # native-resolution originals, re-encoded from the
                    # source file; unreadable paths fall back to the batch
                    for p, arr in zip(paths, u8):
                        jobs.append(pool.submit(
                            _reencode_original, Path(p), arr,
                            out_dir / f"{Path(p).stem}_orig.jpg", quality))
                for aug_idx, _lvl, aug in self.augment_copies(batch01,
                                                              class_name):
                    aug_u8 = I.to_uint8(aug).cpu().numpy()
                    for p, arr in zip(paths, aug_u8):
                        jobs.append(pool.submit(
                            _write_jpeg, arr,
                            out_dir / f"{Path(p).stem}_aug{aug_idx}.jpg",
                            quality))
                drain(max_pending)
            drain(0)
        log.info("materialized %d images into %s", saved, out_dir)
        return saved

    def online_batches(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                       class_of_label, *, include_original: bool = True
                       ) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
        """Online mode: for each ``(uint8 batch, labels)`` yield the
        original and every augmented copy, in [0, 1] on the device.
        ``class_of_label(label) -> "live" | "spoof"``.  Each class's
        sub-batch is wrap-padded to the full batch, augmented, and cut
        back."""
        for u8, labels in batches:
            batch01 = I.to_float(torch.as_tensor(np.asarray(u8)).to(
                self.device))
            if include_original:
                yield batch01, labels
            labels = np.asarray(labels)
            b_full = batch01.shape[0]
            for cls in ("live", "spoof"):
                idx = np.where(np.asarray(
                    [class_of_label(int(l)) == cls for l in labels]))[0]
                n = len(idx)
                if n == 0:
                    continue
                rows = torch.from_numpy(np.resize(idx, b_full)).to(
                    self.device)
                padded = batch01.index_select(0, rows)
                for _idx, _lvl, aug in self.augment_copies(padded, cls):
                    yield aug[:n], labels[idx]


def _reencode_original(src: Path, fallback_u8: np.ndarray, path: Path,
                       quality: int) -> int:
    """The native-resolution ``_orig.jpg``; falls back to the pipeline's
    resized array for virtual or unreadable sources."""
    try:
        from PIL import Image
        arr = np.asarray(Image.open(src).convert("RGB"), np.uint8)
    except Exception:                           # noqa: BLE001
        log.debug("original %s unreadable — encoding the resized "
                  "pipeline copy", src)
        arr = fallback_u8
    return _write_jpeg(arr, path, quality)


def _write_jpeg(arr_u8: np.ndarray, path: Path, quality: int) -> int:
    """One JPEG through the native codec (libjpeg, the GIL released for
    the whole compress), else PIL; an error (PIL missing included) is
    logged and counts 0."""
    try:
        from ..data.native import native_encode_jpeg
        data = native_encode_jpeg(arr_u8, quality)
        if data is not None:
            path.write_bytes(data)
            return 1
        from PIL import Image
        Image.fromarray(arr_u8).save(path, quality=quality)
        return 1
    except Exception as e:                      # noqa: BLE001
        log.error("error saving %s: %s", path, e)
        return 0


def print_statistics(input_dir: str, output_dir: str):
    """Before/after class counts, the spoof:live ratio and the output
    size (the reference's ``print_statistics``)."""
    stats = {}
    for root, name in ((input_dir, "input"), (output_dir, "output")):
        rootp = Path(root)
        counts = {}
        total_bytes = 0
        for cls in ("live", "spoof"):
            n = 0
            for pattern in (f"**/{cls}/*.png", f"**/{cls}/*.jpg",
                            f"**/{cls}/*.jpeg"):
                for f in rootp.glob(pattern):
                    n += 1
                    total_bytes += f.stat().st_size
            counts[cls] = n
        ratio = counts["spoof"] / counts["live"] if counts["live"] else 0.0
        stats[name] = {**counts, "ratio_spoof_to_live": ratio,
                       "gb": total_bytes / 1024 ** 3}
        log.info("%s: live=%d spoof=%d ratio=1:%.2f (spoof:live) "
                 "size=%.2fGB", name, counts["live"], counts["spoof"],
                 ratio, stats[name]["gb"])
    return stats
