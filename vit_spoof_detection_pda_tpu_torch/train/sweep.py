"""Hyperparameter sweep driver: the port's copy of the JAX package's
``train/sweep.py``, which the port keeps without JAX.

Reference: wandb Bayesian sweep, 12 runs, maximizing ``val/optimal_f1``
(train_advanced.py:697-744) with space: lr log-U[5e-5, 5e-4],
batch_size in {96,128,160}, wd log-U[0.01, 0.1], dropout {0,.1,.2},
loss type {focal, weighted_ce}, focal alpha {.15,.25,.35}, gamma
{1.5,2,2.5}; the simple variant runs 10 on val/auc (simple/train.py:490-531).

Built-in searcher: a Gaussian-process surrogate (RBF kernel on the
encoded space: normalized log/linear for continuous, ordinal for numeric
choices, one-hot for categorical) with Expected Improvement acquisition
(``method="bayes"``, the default); ``method="random_exploit"`` keeps the
random+perturb searcher.  ``_gp_ei`` finishes in f32 as the JAX copy
does (its ``jax.scipy.special.erf`` runs at f32 with x64 off), so both
propose the same trials for the same seed and objective.  When wandb IS
installed, `run_wandb_sweep` drives the identical space through a real
wandb Bayesian sweep.
"""

from __future__ import annotations

import logging
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..config import Config

log = logging.getLogger(__name__)

# (dotted config path, sampler spec)
DEFAULT_SPACE = {
    "optim.learning_rate": ("log_uniform", 5e-5, 5e-4),
    "data.batch_size": ("choice", [96, 128, 160]),
    "optim.weight_decay": ("log_uniform", 0.01, 0.1),
    "model.dropout": ("choice", [0.0, 0.1, 0.2]),
    "loss.loss_type": ("choice", ["focal", "weighted_ce"]),
    "loss.focal_alpha": ("choice", [0.15, 0.25, 0.35]),
    "loss.focal_gamma": ("choice", [1.5, 2.0, 2.5]),
}


def _sample(spec, rng: random.Random):
    kind = spec[0]
    if kind == "log_uniform":
        lo, hi = spec[1], spec[2]
        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    if kind == "uniform":
        return rng.uniform(spec[1], spec[2])
    if kind == "choice":
        return rng.choice(spec[1])
    raise ValueError(f"unknown sampler {kind}")


def _perturb(spec, value, rng: random.Random):
    """Exploit step: jiggle a continuous param, resample a choice."""
    kind = spec[0]
    if kind == "log_uniform":
        lo, hi = spec[1], spec[2]
        jittered = value * math.exp(rng.uniform(-0.3, 0.3))
        return min(max(jittered, lo), hi)
    if kind == "uniform":
        lo, hi = spec[1], spec[2]
        return min(max(value + rng.uniform(-0.1, 0.1) * (hi - lo), lo), hi)
    return _sample(spec, rng)


@dataclass
class SweepResult:
    overrides: dict
    metric: float
    run_index: int
    all_metrics: dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# GP-EI Bayesian searcher (pure numpy; trial counts are ~12 so the O(n^3)
# GP solve is trivial)
# --------------------------------------------------------------------------


def _encode(space, overrides) -> np.ndarray:
    parts = []
    for k, spec in space.items():
        v = overrides[k]
        kind = spec[0]
        if kind == "log_uniform":
            lo, hi = math.log(spec[1]), math.log(spec[2])
            parts.append([(math.log(v) - lo) / (hi - lo)])
        elif kind == "uniform":
            lo, hi = spec[1], spec[2]
            parts.append([(v - lo) / (hi - lo)])
        else:
            opts = spec[1]
            if any(isinstance(o, str) for o in opts):
                row = [0.0] * len(opts)
                row[opts.index(v)] = 1.0
                parts.append(row)
            else:
                i = opts.index(v)
                parts.append([i / max(len(opts) - 1, 1)])
    return np.concatenate(parts)


def _gp_ei(x_seen: np.ndarray, y_seen: np.ndarray, x_cand: np.ndarray,
           length_scale: float = 0.35, noise: float = 1e-4) -> np.ndarray:
    """Expected Improvement of candidates under an RBF-kernel GP fit to
    (x_seen, y_seen) (maximization; y standardized internally).  The GP
    solve runs in float64; from the erf on, EI is f32, as the JAX package
    computes it (``jax.scipy.special.erf`` with x64 off), so the argmax
    picks the same candidate."""
    import torch

    mu_y, sd_y = float(np.mean(y_seen)), float(np.std(y_seen)) or 1.0
    y = (y_seen - mu_y) / sd_y

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / length_scale ** 2)

    kxx = k(x_seen, x_seen) + noise * np.eye(len(x_seen))
    kxc = k(x_seen, x_cand)
    sol = np.linalg.solve(kxx, np.column_stack([y, kxc]))
    alpha, v = sol[:, 0], sol[:, 1:]
    mean = kxc.T @ alpha
    var = np.clip(1.0 - np.sum(kxc * v, axis=0), 1e-12, None)
    sd = np.sqrt(var)
    best = y.max()
    z = (mean - best) / sd
    phi = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    cdf = 0.5 * (1.0 + torch.special.erf(f32(z / math.sqrt(2))))
    return (f32(sd) * (f32(z) * cdf + f32(phi))).numpy()


def run_sweep(base_config: Config,
              train_fn: Callable[[Config], Dict[str, float]],
              *, metric: str = "optimal_f1", count: int = 12,
              space: Optional[dict] = None, seed: int = 0,
              method: str = "bayes", n_init: int = 4,
              n_candidates: int = 512,
              explore_fraction: float = 0.5) -> List[SweepResult]:
    """Run `count` trials maximizing `metric`; returns results sorted
    best-first.

    method="bayes" (default): `n_init` random trials, then GP-EI picks
    each next point from `n_candidates` random candidates — the same
    shape as the reference's wandb Bayesian sweep, self-contained.
    method="random_exploit": random exploration then perturb-the-best.
    """
    if method not in ("bayes", "random_exploit"):
        raise ValueError(f"unknown sweep method {method!r} "
                         "(bayes | random_exploit)")
    space = space or DEFAULT_SPACE
    rng = random.Random(seed)
    results: List[SweepResult] = []

    def _finite_key(r):
        # a diverged trial's NaN metric must rank WORST, not poison the
        # sort/argmax (NaN comparisons are arbitrary-order)
        return r.metric if math.isfinite(r.metric) else -math.inf

    def propose(i):
        if method == "random_exploit":
            n_explore = max(1, int(count * explore_fraction))
            if i < n_explore or not results:
                return {k: _sample(v, rng) for k, v in space.items()}
            best = max(results, key=_finite_key)
            return {k: _perturb(space[k], best.overrides[k], rng)
                    for k in space}
        if i < n_init or len(results) < 2:
            return {k: _sample(v, rng) for k, v in space.items()}
        finite = [r for r in results if math.isfinite(r.metric)]
        if len(finite) < 2:
            return {k: _sample(v, rng) for k, v in space.items()}
        x_seen = np.stack([_encode(space, r.overrides) for r in finite])
        y_seen = np.asarray([r.metric for r in finite])
        cands = [{k: _sample(v, rng) for k, v in space.items()}
                 for _ in range(n_candidates)]
        x_cand = np.stack([_encode(space, c) for c in cands])
        ei = _gp_ei(x_seen, y_seen, x_cand)
        return cands[int(np.argmax(ei))]

    for i in range(count):
        overrides = propose(i)
        cfg = base_config.with_overrides(overrides)
        if hasattr(cfg, "checkpoint"):
            # per-trial checkpoint directory: trials run sequentially
            # in-process, and a shared save_dir would make each trial's
            # fresh-run save purge the previous trial's checkpoints
            # (utils/checkpoint.py stale-run semantics).  The reference
            # disambiguates with wandb run ids in the filename
            # (train_advanced.py:660-664); subdirectories are the
            # native-checkpoint equivalent.
            cfg = cfg.with_overrides({
                "checkpoint.save_dir":
                    f"{cfg.checkpoint.save_dir}/trial_{i:02d}"})
        metrics = train_fn(cfg)
        if metric not in metrics:
            # -inf here would silently degrade the whole sweep to random
            # order (the GP never sees a finite point and `best` becomes
            # arbitrary) — after N full training runs, that must be loud
            raise KeyError(
                f"sweep metric {metric!r} missing from train_fn result "
                f"(got {sorted(metrics)}); optimal_* keys need "
                "threshold.optimize=True — use metric='val_f1' otherwise")
        score = float(metrics[metric])
        results.append(SweepResult(overrides, score, i, dict(metrics)))
        log.info("sweep run %d/%d %s=%.5f %s", i + 1, count, metric, score,
                 overrides)

    results.sort(key=_finite_key, reverse=True)
    return results


def _wandb_parameters(space):
    """Translate a sampler-spec space to wandb sweep parameters.

    Both sweeps must search the SAME space (module docstring); deriving
    the wandb config from the spec instead of restating it keeps them
    from drifting.  wandb param names are the dotted path's leaf (the
    reference's flat names, train_advanced.py:699-719)."""
    out = {}
    for path, spec in space.items():
        name = path.split(".")[-1]
        if name in out:
            raise ValueError(f"space has colliding leaf name {name!r}")
        if spec[0] == "log_uniform":
            out[name] = {"distribution": "log_uniform_values",
                         "min": spec[1], "max": spec[2]}
        elif spec[0] == "uniform":
            out[name] = {"distribution": "uniform",
                         "min": spec[1], "max": spec[2]}
        elif spec[0] == "choice":
            out[name] = {"values": list(spec[1])}
        else:
            raise ValueError(f"unknown sampler {spec[0]}")
    return out


def run_wandb_sweep(base_config: Config,
                    train_fn: Callable[[Config], Dict[str, float]],
                    *, metric: str = "optimal_f1", count: int = 12,
                    project: str = "face-antispoofing-tpu", space=None):
    """Drive the same space through a wandb Bayesian sweep (only when
    wandb is installed; reference train_advanced.py:697-744)."""
    import wandb  # raises ImportError when absent — caller gates

    space = space or DEFAULT_SPACE
    sweep_config = {
        "method": "bayes",
        "metric": {"name": f"val/{metric}", "goal": "maximize"},
        "parameters": _wandb_parameters(space),
    }
    sweep_id = wandb.sweep(sweep_config, project=project)

    def agent_fn():
        run = wandb.init()
        overrides = {path: getattr(run.config, path.split(".")[-1])
                     for path in space}
        cfg = base_config.with_overrides(overrides)
        if hasattr(cfg, "checkpoint") and cfg.checkpoint.save_dir:
            # per-run checkpoint dir — same cross-trial purge hazard
            # run_sweep's trial_%02d subdirs fix; the reference
            # disambiguates with the wandb run id too (:660-664)
            cfg = cfg.with_overrides({
                "checkpoint.save_dir":
                    f"{cfg.checkpoint.save_dir}/{run.id}"})
        metrics = train_fn(cfg)
        if metric not in metrics:
            raise KeyError(
                f"sweep metric {metric!r} missing from train_fn result "
                f"(got {sorted(metrics)})")
        wandb.log({f"val/{metric}": metrics[metric]})

    wandb.agent(sweep_id, function=agent_fn, count=count)
    return sweep_id
