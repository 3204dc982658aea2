"""Dataset scanning, splitting, and manifest persistence (the port's copy
of the JAX package's ``data/manifest.py``).

Replaces the reference's three copy-pasted scanners —
``scan_dataset`` (subject tree, simple/train.py:110-135),
``scan_augmented_dataset`` (flat store, train_advanced.py:142-163),
``TestDataset`` scanning (test.py:106-128) — with one Record type and
three thin scan functions; the split replicates the reference's
stratified sklearn ``train_test_split(seed=42)`` exactly when sklearn is
present (train_advanced.py:540-545) and falls back to a deterministic
seeded shuffle otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from .conventions import to_canonical

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Record:
    path: str
    label: int                 # canonical: 1 = live
    subject: Optional[str] = None
    name: Optional[str] = None


def scan_raw(root: str, extensions=(".png", ".jpg", ".jpeg")) -> List[Record]:
    """Walk ``root/<subject>/{live,spoof}/*`` (the CelebA-Spoof layout the
    reference scans, simple/train.py:110-135)."""
    rootp = Path(root)
    records = []
    for subject_dir in sorted(p for p in rootp.iterdir() if p.is_dir()):
        for cls in ("live", "spoof"):
            cls_dir = subject_dir / cls
            if not cls_dir.is_dir():
                continue
            for f in sorted(cls_dir.iterdir()):
                if f.suffix.lower() in extensions:
                    records.append(Record(
                        path=str(f), label=to_canonical(cls),
                        subject=subject_dir.name, name=f.name))
    _log_counts("raw", records)
    return records


def scan_augmented(root: str, extensions=(".jpg", ".jpeg", ".png")
                   ) -> List[Record]:
    """Scan the flat augmented store ``root/{live,spoof}/*``
    (train_advanced.py:142-163)."""
    rootp = Path(root)
    records = []
    for cls in ("live", "spoof"):
        cls_dir = rootp / cls
        if not cls_dir.is_dir():
            continue
        for f in sorted(cls_dir.iterdir()):
            if f.suffix.lower() in extensions:
                records.append(Record(path=str(f), label=to_canonical(cls),
                                      name=f.name))
    _log_counts("augmented", records)
    return records


def scan_test(root: str, extensions=(".png", ".jpg", ".jpeg")
              ) -> List[Record]:
    """Test split scan — same layout as raw but records keep subject and
    image name for per-image / per-subject reporting (test.py:106-128).
    Also accepts the harness's flat ``test_inf/{live,spoof}`` layout
    (evaluate_all_models.py:44-56)."""
    rootp = Path(root)
    if (rootp / "live").is_dir() or (rootp / "spoof").is_dir():
        return scan_augmented(root, extensions)
    return scan_raw(root, extensions)


def _log_counts(kind: str, records: Sequence[Record]):
    live = sum(1 for r in records if r.label == 1)
    spoof = len(records) - live
    log.info("%s scan: %d images (%d live / %d spoof)",
             kind, len(records), live, spoof)


# --------------------------------------------------------------------------
# Split
# --------------------------------------------------------------------------


def stratified_split(records: Sequence[Record], train_frac: float = 0.85,
                     seed: int = 42) -> Tuple[List[Record], List[Record]]:
    """Stratified train/val split.

    Uses sklearn's ``train_test_split(stratify=labels, random_state=seed)``
    when available so the split is IDENTICAL to the reference's
    (train_advanced.py:540-545); otherwise a seeded per-class shuffle
    (deterministic, stratified, but a different permutation).
    """
    labels = [r.label for r in records]
    try:
        from sklearn.model_selection import train_test_split
        train, val = train_test_split(
            list(records), train_size=train_frac, stratify=labels,
            random_state=seed)
        return list(train), list(val)
    except ImportError:
        import random
        rng = random.Random(seed)
        by_class = {}
        for r in records:
            by_class.setdefault(r.label, []).append(r)
        train, val = [], []
        for rs in by_class.values():
            rs = rs[:]
            rng.shuffle(rs)
            k = round(len(rs) * train_frac)
            train.extend(rs[:k])
            val.extend(rs[k:])
        rng.shuffle(train)
        rng.shuffle(val)
        return train, val


# --------------------------------------------------------------------------
# Persistence (the simple variant writes train_files.txt / val_files.txt,
# simple/train.py:150-156; we persist full JSONL manifests)
# --------------------------------------------------------------------------


def save_manifest(records: Sequence[Record], path: str):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(dataclasses.asdict(r)) + "\n")


def load_manifest(path: str) -> List[Record]:
    out = []
    with open(path) as f:
        for line in f:
            out.append(Record(**json.loads(line)))
    return out


def class_counts(records: Sequence[Record]) -> Tuple[int, int]:
    """(count_label0, count_label1) for class-weight computation
    (train_advanced.py:522-529)."""
    c1 = sum(1 for r in records if r.label == 1)
    return len(records) - c1, c1
