"""Checkpoints of the port's training state, with true resume
(counterpart of the JAX package's ``utils/checkpoint.py``, in the port's
own format instead of Orbax).

The reference saves epoch + model/optimizer/scheduler state dicts
(train_advanced.py:475-489) but restores only the model (test.py:167-188).
Here the full ``TrainState`` round-trips: one directory per step,

    <directory>/<step>/state.pt      torch.save of {"step", "params" (the
                                     JAX-layout tree), "opt_state" (AdamW's
                                     count and moments, the EMA shadow, the
                                     accumulation), "paths", "seed",
                                     "torch_rng", "data"}
    <directory>/<step>/metrics.json  the metrics of the save
    <directory>/<step>/config.json   the config tree, when given
    <directory>/<step>/PINNED        present for a save exempt from
                                     best-k retention

every tensor on the CPU, so ``torch.load(weights_only=True)`` reads it.
The dropout generators derive from ``(seed, step)``; ``data`` holds the
data position (epoch and batch within it) of the step.  A save is written
into a temporary directory and renamed into place, so a reader never sees
half a checkpoint.

An Orbax directory written by the JAX package is read by
:func:`load_checkpoint_bundle` where ``orbax`` imports (behind a lazy
import); elsewhere it raises saying so.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _py(v) -> Any:
    return v.item() if hasattr(v, "item") else v


def _cpu_copy(tree):
    """The tree with every tensor detached and copied to the CPU (a
    snapshot a background writer can own)."""
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _state_payload(state, data: Optional[dict]) -> dict:
    return {"step": int(state.step), "params": _cpu_copy(state.params),
            "opt_state": _cpu_copy(state.opt_state),
            "paths": [list(p) for p in state.paths], "seed": int(state.seed),
            "torch_rng": torch.get_rng_state(), "data": data or {}}


def _port_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit()
                  and os.path.exists(os.path.join(directory, n, STATE_FILE)))


class CheckpointManager:
    """Best-k checkpoints of a ``TrainState`` (JAX ``CheckpointManager``
    :29).

    ``max_to_keep`` checkpoints are kept, ranked by ``metrics[best_metric]``
    (``best_mode`` "max" or "min"; a save without the metric ranks worst;
    ties keep the newer step); pinned saves are never removed.
    ``async_save=True`` writes on a background thread: ``save`` returns
    once the state is copied off the card, and every read, every later
    save and :meth:`wait_until_finished` wait for the write first, so the
    directory is always consistent.

    In a multi-rank run (``parallel/mesh.py``) the ranks hold the same
    state: rank 0 writes it and the other ranks' ``save`` writes nothing
    (the Trainer waits at a barrier after each save); every rank restores
    from the shared directory."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 best_metric: str = "val_f1", best_mode: str = "max",
                 async_save: bool = False):
        if best_mode not in ("max", "min"):
            raise ValueError("best_mode must be 'max' or 'min'")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state, *, metrics: Optional[dict] = None,
             config: Optional[dict] = None, pin: bool = False,
             data: Optional[dict] = None) -> bool:
        """Save ``state`` (and ``metrics``, ``config``, the data position
        ``data``) at ``step``; returns True.

        A checkpoint already at ``step`` is overwritten (a fresh run into
        a used directory must not crash; the reference's ``torch.save``
        overwrites too).  A save below every existing step is a fresh run
        in a used directory: the previous run's later checkpoints are
        deleted, or ``latest_step`` would keep serving them.  A save
        merely below the latest step keeps the later ones (branch
        resume) and warns.  ``pin=True`` exempts the checkpoint from
        best-k retention (the preemption save).  On a rank other than 0
        nothing is written and False is returned."""
        from ..parallel.mesh import is_primary
        if not is_primary():
            return False
        self.wait_until_finished()
        existing = self.all_steps()
        if existing and step <= existing[-1]:
            if step in existing:
                log.warning("overwriting existing checkpoint at step %d "
                            "(fresh run into a used save_dir?)", step)
                self._delete(step)
            rest = [s for s in existing if s != step]
            if rest and step < rest[0]:
                for stale in rest:
                    log.warning(
                        "deleting stale checkpoint at step %d from a "
                        "previous run (fresh run now at step %d)",
                        stale, step)
                    self._delete(stale)
            elif any(s > step for s in rest):
                log.warning(
                    "saving step %d below the directory's latest step %d"
                    " — later checkpoints are kept (branch resume?); "
                    "latest_step() will prefer them", step, existing[-1])
        payload = _state_payload(state, data)
        metrics = {k: _py(v) for k, v in (metrics or {}).items()}
        config = None if config is None else json.loads(json.dumps(config))

        def write():
            try:
                self._write(step, payload, metrics, config, pin)
                self._retain()
            except BaseException as e:                 # noqa: BLE001
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True,
                                            name=f"checkpoint-{step}")
            self._thread.start()
        else:
            write()
            self._raise_error()
        return True

    def _write(self, step, payload, metrics, config, pin):
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump(metrics, f)
        if config is not None:
            with open(os.path.join(tmp, "config.json"), "w") as f:
                json.dump(config, f)
        if pin:
            open(os.path.join(tmp, "PINNED"), "w").close()
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def _retain(self):
        """Delete all but the ``max_to_keep`` best unpinned checkpoints."""
        if self.max_to_keep is None:
            return
        ranked = []
        for step in _port_steps(self.directory):
            if os.path.exists(os.path.join(self._step_dir(step), "PINNED")):
                continue
            value = self._read_metrics(step).get(self.best_metric)
            if value is None or not np.isfinite(value):
                value = -np.inf if self.best_mode == "max" else np.inf
            ranked.append((value if self.best_mode == "max" else -value,
                           step))
        ranked.sort(reverse=True)                    # best first, newer first
        for _, step in ranked[self.max_to_keep:]:
            self._delete(step)

    def _delete(self, step: int):
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _raise_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    # -- restore ------------------------------------------------------------

    def wait_until_finished(self):
        """Wait for a pending background write (no-op when synchronous);
        raises if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_error()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        self.wait_until_finished()
        return _port_steps(self.directory)

    def best_step(self) -> Optional[int]:
        """The step with the best metric among the unpinned checkpoints
        (the newest on a tie), or None."""
        best = None
        for step in self.all_steps():
            if os.path.exists(os.path.join(self._step_dir(step), "PINNED")):
                continue
            value = self._read_metrics(step).get(self.best_metric)
            if value is None:
                continue
            key = value if self.best_mode == "max" else -value
            if best is None or key >= best[0]:
                best = (key, step)
        return None if best is None else best[1]

    def _read_metrics(self, step: int) -> dict:
        path = os.path.join(self._step_dir(step), "metrics.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def restore(self, state, step: Optional[int] = None):
        """Restore the checkpoint at ``step`` (the latest by default) into
        ``state`` in place: parameters and optimizer tensors are copied
        into the existing tensors (on their device), and the step, seed
        and the global torch generator are set.  Returns ``state``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = _load_payload(self._step_dir(step))
        paths = [tuple(p) for p in payload["paths"]]
        if paths != [tuple(p) for p in state.paths]:
            raise ValueError(
                f"checkpoint at step {step} holds another parameter tree "
                f"({len(paths)} leaves) than this trainer's "
                f"({len(state.paths)})")
        from ..train.state import tree_flatten

        saved_opt = payload["opt_state"]
        with torch.no_grad():
            for dst, src in zip(state.leaves(),
                                tree_flatten(payload["params"])[0]):
                dst.copy_(src)
            for key in ("mu", "nu", "ema", "acc"):
                have, got = state.opt_state.get(key), saved_opt.get(key)
                if (have is None) != (got is None):
                    raise ValueError(
                        f"optimizer state {key!r} is "
                        f"{'absent' if got is None else 'present'} in the "
                        "checkpoint but not in this trainer's optimizer")
                for dst, src in zip(have or [], got or []):
                    dst.copy_(src)
        state.opt_state["count"] = int(saved_opt["count"])
        state.opt_state["mini_step"] = int(saved_opt["mini_step"])
        state.step = int(payload["step"])
        state.seed = int(payload["seed"])
        torch.set_rng_state(payload["torch_rng"])
        return state

    def restore_metrics(self, step: Optional[int] = None) -> dict:
        if step is None:
            step = self.latest_step()
        self.wait_until_finished()
        return self._read_metrics(step)

    def restore_data_position(self, step: Optional[int] = None) -> dict:
        """The data position saved with the checkpoint (``{}`` if none)."""
        if step is None:
            step = self.latest_step()
        return dict(_load_payload(self._step_dir(step)).get("data") or {})

    def close(self):
        self.wait_until_finished()


def _load_payload(step_dir: str) -> dict:
    return torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                      weights_only=True)


def load_params_from_dir(directory: str, step: Optional[int] = None):
    """``(variables, step)``: the parameters of a checkpoint directory
    without a ``TrainState`` template (JAX :219)."""
    variables, step, _metrics = load_checkpoint_bundle(directory, step)
    return variables, step


def list_checkpoints(directory: str) -> list:
    """``[(step, metrics)]`` ascending: a metrics-only read (JAX :266).
    Steps saved without metrics report ``{}``."""
    directory = os.path.abspath(directory)
    if not _port_steps(directory) and _is_orbax_dir(directory):
        return _orbax_list(directory)
    out = []
    for step in _port_steps(directory):
        path = os.path.join(directory, str(step), "metrics.json")
        metrics = {}
        if os.path.exists(path):
            with open(path) as f:
                metrics = json.load(f)
        out.append((step, metrics))
    return out


def load_checkpoint_bundle(directory: str, step: Optional[int] = None,
                           ema: bool = False):
    """``(variables, step, metrics)`` of a checkpoint directory (JAX :291):
    the parameters as a JAX-layout tree of CPU tensors under
    ``{"params": ...}``, and the metrics JSON.  ``ema=True`` hands back
    the EMA shadow instead of the last iterate, and raises if the run
    trained without EMA.  The port's directories are read here; a JAX
    Orbax directory is read through ``orbax`` where it imports."""
    directory = os.path.abspath(directory)
    steps = _port_steps(directory)
    if not steps:
        if _is_orbax_dir(directory):
            return _orbax_bundle(directory, step, ema)
        raise FileNotFoundError(f"no checkpoints in {directory}")
    if step is None:
        step = steps[-1]
    step_dir = os.path.join(directory, str(int(step)))
    payload = _load_payload(step_dir)
    params = payload["params"]
    if ema:
        shadow = payload["opt_state"].get("ema")
        if shadow is None:
            raise ValueError(
                f"checkpoint at {directory} (step {step}) has no EMA "
                "state — train with optim.ema_decay set")
        from ..train.state import tree_unflatten
        params = tree_unflatten([tuple(p) for p in payload["paths"]], shadow)
    metrics_path = os.path.join(step_dir, "metrics.json")
    metrics = {}
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            metrics = json.load(f)
    return {"params": params}, int(step), metrics


# --------------------------------------------------------------------------
# The JAX package's Orbax directories (read only, where orbax imports)
# --------------------------------------------------------------------------

_ORBAX_MISSING = (
    "{directory} is an Orbax checkpoint directory of the JAX package; the "
    "port reads it only where the orbax package imports ({err})")


def _is_orbax_dir(directory: str) -> bool:
    """Numeric step directories holding Orbax's items (``tree``,
    ``metrics``) rather than the port's ``state.pt``."""
    if not os.path.isdir(directory):
        return False
    return any(n.isdigit() and os.path.isdir(os.path.join(directory, n, "tree"))
               for n in os.listdir(directory))


def _orbax():
    import orbax.checkpoint as ocp
    return ocp


def _orbax_manager(directory: str):
    try:
        ocp = _orbax()
    except ImportError as e:
        raise NotImplementedError(_ORBAX_MISSING.format(
            directory=directory, err=e)) from e
    return ocp, ocp.CheckpointManager(
        directory,
        options=ocp.CheckpointManagerOptions(enable_async_checkpointing=False),
        item_handlers={"tree": ocp.PyTreeCheckpointHandler(),
                       "metrics": ocp.JsonCheckpointHandler()})


def _map_tree(fn, node):
    if isinstance(node, dict):
        return {k: _map_tree(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_tree(fn, v) for v in node)
    return fn(node)


def _find_ema_subtree(node):
    """The EMA shadow in a restored JAX opt_state: a container whose only
    child is ``polyak_shadow`` (JAX ``_find_ema_subtree``)."""
    if isinstance(node, dict):
        if set(node) == {"polyak_shadow"}:
            return node["polyak_shadow"]
        children = node.values()
    elif isinstance(node, (list, tuple)):
        children = node
    else:
        return None
    for sub in children:
        found = _find_ema_subtree(sub)
        if found is not None:
            return found
    return None


def _orbax_bundle(directory: str, step: Optional[int], ema: bool):
    ocp, mgr = _orbax_manager(directory)
    try:
        if step is None:
            step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        meta = mgr.item_metadata(step)["tree"]
        restore_args = {k: _map_tree(
            lambda _m, _k=k: (ocp.RestoreArgs(restore_type=np.ndarray)
                              if _k == "state" else ocp.RestoreArgs()), v)
            for k, v in meta.items()}
        restored = mgr.restore(step, args=ocp.args.Composite(
            tree=ocp.args.PyTreeRestore(restore_args=restore_args),
            metrics=ocp.args.JsonRestore()))
        tree = restored["tree"]["state"]
        params = tree["params"]
        if ema:
            params = _find_ema_subtree(tree.get("opt_state"))
            if params is None:
                raise ValueError(
                    f"checkpoint at {directory} (step {step}) has no EMA "
                    "state — train with optim.ema_decay set")
        if "blocks" in params.get("vit", {}):
            # a pipeline-parallel run's packed layout (params and its EMA
            # shadow alike): back to the per-layer block{i} subtrees
            from ..parallel.pipeline import unpack_pipeline_params
            params = unpack_pipeline_params({"params": params})["params"]
        params = _map_tree(lambda a: torch.from_numpy(np.array(a)), params)
        return {"params": params}, int(step), dict(restored["metrics"] or {})
    finally:
        mgr.close()


def _orbax_list(directory: str) -> list:
    ocp, mgr = _orbax_manager(directory)
    try:
        out = []
        for step in sorted(mgr.all_steps()):
            try:
                restored = mgr.restore(step, args=ocp.args.Composite(
                    metrics=ocp.args.JsonRestore()))
                metrics = dict(restored["metrics"] or {})
            except (KeyError, FileNotFoundError):
                metrics = {}
            out.append((int(step), metrics))
        return out
    finally:
        mgr.close()
