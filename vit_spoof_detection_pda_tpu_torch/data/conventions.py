"""Label-convention adapter (the port's copy of the JAX package's
``data/conventions.py``).

The reference uses TWO conflicting conventions (SURVEY.md §0):

- train/test stack: **1 = live**, score = P(live)
  (reference test.py:117 `label = 1 if 'live' ...`, :217
  `probs[:, 1]  # probability of being live`),
- cross-model harness: **0 = live, 1 = spoof**, score = P(spoof)
  (reference evaluate_all_models.py:38-42, :145),

and its APCER/BPCER formulas are written against the harness convention
(evaluate_all_models.py:91-94).  This framework fixes ONE canonical
convention — 1 = live, scores = P(live) — and converts at the boundary
when reproducing harness-convention artifacts.
"""

from __future__ import annotations

import numpy as np

CANONICAL_LIVE = 1   # canonical: label 1 = live, score = P(live)


def to_canonical(is_live) -> int:
    """bool/str -> canonical label.  Strings are matched
    case-insensitively and UNKNOWN strings raise — silently mapping a
    typo ("Live", "real") to spoof would corrupt every label with no
    error."""
    if isinstance(is_live, str):
        low = is_live.strip().lower()
        if low not in ("live", "spoof"):
            raise ValueError(
                f"unknown class name {is_live!r} (expected 'live' or "
                "'spoof')")
        is_live = low == "live"
    return 1 if is_live else 0


def harness_labels(canonical_labels):
    """canonical (1=live) -> harness (1=spoof)."""
    return 1 - np.asarray(canonical_labels)


def harness_scores(p_live):
    """P(live) -> P(spoof)."""
    return 1.0 - np.asarray(p_live)
