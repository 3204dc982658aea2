"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference (``reference/vit.py``) works out
from the same inputs.  Each is compared with the limit its cell's
workload file states (``limits``); PERF.md gives the readings each limit
was set from."""

from __future__ import annotations

import numpy as np
import torch


def _margin(p: np.ndarray) -> np.ndarray:
    """The logit margin ``log(p / (1 - p))`` of P(live), clipped to +-30
    (the score's float32 holds no more)."""
    p = np.clip(p.astype(np.float64), 1e-13, 1 - 1e-13)
    return np.clip(np.log(p) - np.log1p(-p), -30.0, 30.0)


def score_gaps(scores: np.ndarray, ref: np.ndarray, which: np.ndarray) -> dict:
    """Gaps of every answer against the reference's P(live) of its input,
    as logit margins ``log(p / (1 - p))``: ``margin_max``, the widest gap,
    and ``margin_spread``, the gaps' standard deviation about their mean.
    ``scores``: P(live)
    the program returned; ``ref``: P(live) of each distinct input;
    ``which``: the input of each answer.  An answer that never came is
    NaN and fails every limit."""
    scores = scores.astype(np.float64)
    want = ref.astype(np.float64)[which]
    if scores.size == 0 or not np.isfinite(scores - want).all():
        return dict.fromkeys(("margin_max", "margin_spread"), float("inf"))
    dm = _margin(scores) - _margin(want)
    return {"margin_max": float(np.abs(dm).max()),
            "margin_spread": float(dm.std())}


def leaf_norms(tree: dict, masks=None) -> dict:
    """``{key: norm}``; ``masks`` keeps each leaf's masked elements."""
    out = {}
    for k, v in tree.items():
        if masks is not None:
            v = v[masks[k].to(v.device)]
        out[k] = float(torch.linalg.vector_norm(v.double()))
    return out


def worst_leaf_gap(prog: dict, ref: dict, masks=None) -> tuple:
    """``(gap, leaf)``: the largest ``| |prog_leaf| - |ref_leaf| |`` over
    the leaves, each against the larger of its reference norm and the
    median leaf's reference norm (some gradients are all but zero).
    ``prog``/``ref``: ``{key: tensor}``; ``masks``: the elements compared
    of each leaf (:func:`moved_elements`; all by default), a leaf with none
    left out."""
    keys = sorted(ref if masks is None else
                  [k for k in ref if bool(masks[k].any())])
    pn = leaf_norms({k: prog[k] for k in keys}, masks)
    rn = leaf_norms({k: ref[k] for k in keys}, masks)
    med = float(np.median([rn[k] for k in keys]))
    worst, leaf = 0.0, None
    for k in keys:
        g = abs(pn[k] - rn[k]) / max(rn[k], med)
        if not np.isfinite(g):
            return float("inf"), k
        if g > worst:
            worst, leaf = g, k
    return worst, leaf


def moved_elements(grad_ref: dict, share: float = 1e-3) -> dict:
    """``{key: bool mask}`` of the elements whose reference gradient is at
    least ``share`` of the median leaf's root mean square: the others
    (the key's third of a qkv bias, under the softmax) have a gradient
    that is nought but for rounding, move under Adam by round-off alone,
    and are left out of the change."""
    rms = [float(v.double().square().mean().sqrt()) for v in
           grad_ref.values()]
    floor = share * float(np.median(rms))
    return {k: (v.abs() >= floor).cpu() for k, v in grad_ref.items()}


def training_gaps(grad1: dict, change: dict, want: dict, w0: dict) -> dict:
    """The training numbers compared, of a run against the reference's
    (``reference/vit.py::train_steps`` from ``w0``), both over
    :func:`moved_elements`: ``grad_diff``, the worst leaf's norm of the
    first gradient's difference (:func:`diff_gap`); ``change_gap``, the
    worst leaf's gap of the change's norm after the steps."""
    want_change = {k: want["params"][k] - w0[k] for k in w0}
    moved = moved_elements(want["grad1"])
    return {"grad_diff": diff_gap(grad1, want["grad1"], moved)[0],
            "change_gap": worst_leaf_gap(change, want_change, moved)[0]}


def diff_gap(prog: dict, ref: dict, masks: dict) -> tuple:
    """``(gap, leaf)``: the largest norm of a leaf's difference over
    :func:`moved_elements`, against the larger of the leaf's reference
    norm and the median leaf's."""
    keys = sorted(k for k in ref if bool(masks[k].any()))
    rn = leaf_norms({k: ref[k] for k in keys}, masks)
    dn = leaf_norms({k: prog[k].to(ref[k].device) - ref[k] for k in keys},
                    masks)
    med = float(np.median([rn[k] for k in keys]))
    gaps = {k: dn[k] / max(rn[k], med) for k in keys}
    if not all(np.isfinite(v) for v in gaps.values()):
        return float("inf"), None
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf
