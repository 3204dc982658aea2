"""Config-driven training orchestrator (counterpart of the JAX package's
``train/trainer.py``).

The reference's ``train()`` (train_advanced.py:492-693) is a 200-line
script: wandb init, seeding, scan, class weights, split, loaders, model,
loss/opt/sched/scaler, epoch loop with best-tracking and early stop.  Here
the lifecycle is the same; the per-batch work is one train step (the
kernels on the card) and validation is one eval step per batch plus
tensor metric reductions (``metrics/device.py``) on the card.  The host
loop only feeds batches and logs, one step behind so it never waits on
the step it just queued.

Data contract: ``train_batches(epoch) -> iterator of {"image": [B,H,W,3]
float32 (normalized) or uint8 for a ``batch_prep``, "label": [B] int}``
(pool mode: ``{"image": the pool, "index": [B], "label": [B]}``);
``val_batches() ->`` the same without ``index``.  The Trainer calls
``train_batches(epoch, skip=n)``: the source starts ``n`` batches into
the epoch (exact mid-epoch resume).

Several ranks (one process each, ``parallel/mesh.py``): the Trainer
takes a ``mesh`` or, in a process group of more than one rank, builds the
one ``config.sharding`` describes, and lays the parameters and the
optimizer state out by it (JAX :119-192): data and sequence parallelism
replicate them; a model axis holds each rank's Megatron slices
(``shard_params``' rules), ``sharding.fsdp`` each rank's chunk of the
large leaves (gathered for the forward, the gradients reduce-scattered),
and ``sharding.pipeline_parallel`` the packed layout with each stage's
depth / S layers (and their moments), trained through the GPipe
schedule (``parallel/pipeline.py::pipeline_apply``) and evaluated on the
module path over the layers gathered from the stages.  Checkpoints hold
the whole leaves (a pipeline run's packed), as the same run on one card
writes them.
Batches are then this rank's rows, the step's metrics the global batch's,
validation gathers every data rank's scores so its metrics, the best-k
choice and the early stop are the same on every rank, and only rank 0
writes checkpoints and telemetry.  ``telemetry.profile_dir`` traces the
first epoch with ``torch.profiler`` (``utils/profiling.py``).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..metrics import device as dmetrics
from ..ops import losses
from ..parallel import mesh as pmesh
from ..utils.checkpoint import CheckpointManager
from ..utils.profiling import profile_trace
from ..utils.telemetry import MetricLogger
from .early_stop import EarlyStopping
from .schedule import make_lr_schedule
from .state import create_train_state, find_ema_params, make_optimizer
from .step import _to, make_eval_step, make_train_step

log = logging.getLogger(__name__)

class _Preempted(Exception):
    """Raised at a safe point (a batch boundary) after a preemption
    request; the fit loop checkpoints and returns."""


def check_sharding(config: Config, mesh=None):
    """The JAX Trainer's sharding rules (JAX ``train/trainer.py``
    :119-190, ``parallel/mesh.py::mesh_from_config``): ``ValueError`` for
    layouts that cannot compose (seq with model or pipeline, fsdp beyond
    pure data parallelism, also on a given ``mesh``) or that do not fit
    the process group's ranks."""
    sh = config.sharding
    pmesh.check_sharding(sh)
    if mesh is None:
        pmesh.config_layout(sh, pmesh.world_size())
        return
    sizes = pmesh.axis_sizes(mesh)
    for axis in (pmesh.MODEL_AXIS, pmesh.PIPE_AXIS):
        if sh.fsdp and sizes.get(axis, 1) > 1:
            # silently dropping fsdp would fake its memory saving
            raise ValueError("fsdp composes with pure data parallelism "
                             f"only (mesh has a {axis} axis > 1)")


def resolve_mesh(config: Config, mesh=None, device=None):
    """The mesh a run trains on: ``mesh`` as given, else the one
    ``config.sharding`` describes over a process group of more than one
    rank, else None (one rank: the single-card path, no collectives)."""
    check_sharding(config, mesh)
    if mesh is None and pmesh.world_size() > 1:
        mesh = pmesh.mesh_from_config(
            config.sharding, device_type=resolve_device(device).type)
    return mesh


def module_tree_apply(module):
    """``apply_fn(variables, x, *, train=False, generator=None)``: the
    port module's own forward (``nn.Module`` path: kernel 8 and its
    backward in the attention) over a JAX-layout ``ViTAntiSpoof`` tree,
    differentiable in its leaves.  Dropout in train mode draws from the
    default generator reseeded from ``generator`` (so a step replays its
    masks), inside ``torch.random.fork_rng``."""
    from ..models.convert import antispoof_state_from_tree

    def apply_fn(variables, x, *, train: bool = False, generator=None):
        sd = antispoof_state_from_tree(variables["params"],
                                       patch_size=module.patch_size)
        module.train(train)
        if not (train and generator is not None and module.dropout > 0):
            return torch.func.functional_call(module, sd, (x,))
        devices = [x.device] if x.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(generator.initial_seed())
            return torch.func.functional_call(module, sd, (x,))

    return apply_fn


class Trainer:
    def __init__(self, config: Config, module, *,
                 train_batches: Callable[[int], Iterable],
                 val_batches: Callable[[], Iterable],
                 steps_per_epoch: int,
                 class_counts=None,
                 variables=None,
                 mesh=None,
                 logger: Optional[MetricLogger] = None,
                 checkpoints: Optional[CheckpointManager] = None,
                 batch_prep=None,
                 device=None,
                 opt_arrays: Optional[dict] = None):
        """``module``: the port's ``ViTAntiSpoof``, computing in its
        ``dtype`` (``compute_dtype``).  ``variables``: a JAX-layout
        ``{"params": ...}`` tree to start from (else the module's own
        weights); ``opt_arrays``: a JAX ``TrainState`` carried across by
        ``models/convert.py::train_state_arrays`` (params, step, AdamW
        moments, EMA).  Runs on the card unless ``device="cpu"``."""
        self.config = config
        self.module = module
        self.train_batches = train_batches
        self.val_batches = val_batches
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(config, mesh, self.device)
        self._preempt = threading.Event()
        # telemetry from rank 0 only; the other ranks log nowhere
        self.logger = logger or (MetricLogger(
            jsonl_path=config.telemetry.jsonl_path,
            wandb_project=config.telemetry.wandb_project,
            wandb_entity=config.telemetry.wandb_entity,
            config=config.to_dict()) if pmesh.is_primary()
            else MetricLogger(echo=False))
        self.checkpoints = checkpoints

        # the accumulation applies one update per k micro-steps, and the
        # schedule advances per update: size its horizon in updates
        self._accum = max(config.optim.gradient_accumulation_steps, 1)
        total_steps = steps_per_epoch * config.optim.num_epochs // self._accum
        warmup_steps = (steps_per_epoch * config.optim.warmup_epochs
                        // self._accum)
        self.lr_schedule = make_lr_schedule(
            config.optim.learning_rate, total_steps, warmup_steps,
            config.optim.min_lr, config.optim.true_warmup)
        tx = make_optimizer(
            self.lr_schedule, weight_decay=config.optim.weight_decay,
            beta1=config.optim.beta1, beta2=config.optim.beta2,
            max_grad_norm=config.optim.max_grad_norm,
            gradient_accumulation_steps=(
                config.optim.gradient_accumulation_steps),
            ema_decay=config.optim.ema_decay)

        class_weights = None
        if config.loss.loss_type == "weighted_ce":
            if class_counts is None:
                raise ValueError("weighted_ce needs class_counts")
            class_weights = losses.class_weights_from_counts(class_counts)
        loss_fn = losses.make_loss_fn(
            config.loss.loss_type, focal_alpha=config.loss.focal_alpha,
            focal_gamma=config.loss.focal_gamma,
            label_smoothing=config.loss.label_smoothing,
            class_weights=class_weights)

        layout, train_apply, eval_apply, variables, opt_arrays = \
            self._layout(config, module, variables, opt_arrays)
        if train_apply is None:
            # the fused training forward over the kernels (JAX make_apply;
            # model.mlp_vjp picks the MLP backward), or the module path
            from ..models.fasttrain import fast_apply_available, make_apply
            if config.model.fused_train_forward and fast_apply_available(
                    module, self.mesh):
                train_apply = make_apply(module,
                                         mlp_mode=config.model.mlp_vjp)
            else:
                train_apply = module_tree_apply(module)
        self.state = create_train_state(
            module, tx, config.seed, variables=variables,
            apply_fn=train_apply, device=self.device, opt_arrays=opt_arrays,
            layout=layout)
        if self.mesh is not None and layout is None:
            # every rank starts from rank 0's parameters and optimizer state
            from ..parallel.collectives import broadcast_params
            opt = self.state.opt_state
            broadcast_params(self.state.leaves() + [
                t for key in ("mu", "nu", "ema", "acc")
                for t in (opt.get(key) or [])])
        self._eval_loss = loss_fn

        # batch_prep: on-card augmentation inside the step (a callable, or
        # {group_tag: callable} for the severity groups; batches then
        # carry a "group" key selecting their step)
        preps = (batch_prep if isinstance(batch_prep, dict)
                 else {None: batch_prep})
        self.train_steps = {tag: make_train_step(loss_fn, batch_prep=prep,
                                                 mesh=self.mesh)
                            for tag, prep in preps.items()}
        self.eval_step = make_eval_step(eval_apply, mesh=self.mesh)

    def _layout(self, config, module, variables, opt_arrays):
        """``(layout, train_apply, eval_apply, variables, opt_arrays)`` of
        the mesh (JAX :119-192): the parameter layout (None: every rank
        holds everything) and the forwards that read it (None: the
        defaults)."""
        from ..models.convert import antispoof_from_torch
        from ..models.vit import ViTAntiSpoof
        base = module_tree_apply(module)
        sizes = pmesh.axis_sizes(self.mesh) if self.mesh is not None else {}
        n_pipe = sizes.get(pmesh.PIPE_AXIS, 1)
        n_model = sizes.get(pmesh.MODEL_AXIS, 1)
        fsdp = config.sharding.fsdp and self.mesh is not None and (
            self.mesh.mesh.numel() > 1)
        if not (n_pipe > 1 or n_model > 1 or fsdp):
            return None, None, base, variables, opt_arrays
        if n_pipe > 1 and not isinstance(module, ViTAntiSpoof):
            raise ValueError("pipeline_parallel supports the ViT anti-spoof "
                             f"module only; got {type(module).__name__}")
        if opt_arrays is not None:
            variables = {"params": opt_arrays["params"]}
        elif variables is None:
            variables = antispoof_from_torch(module.state_dict())
        heads = getattr(module, "num_heads", None)
        if fsdp:
            layout = pmesh.fsdp_layout(variables["params"], self.mesh,
                                       config.sharding.fsdp_min_size)

            def gathered(v):
                return {"params": layout.gather_tree(
                    v["params"], (pmesh.DATA_AXIS,), differentiable=True)}

            def apply_fn(v, x, **kw):
                return base(gathered(v), x, **kw)

            return layout, apply_fn, apply_fn, variables, opt_arrays
        if n_model > 1 and n_pipe == 1:
            layout = pmesh.tp_layout(variables["params"], self.mesh, heads)
            return layout, base, base, variables, opt_arrays
        from ..parallel.pipeline import (pack_pipeline_params, pipe_layout,
                                         pipeline_apply,
                                         unpack_pipeline_params)
        if "blocks" not in variables["params"]["vit"]:
            if opt_arrays is not None:
                raise ValueError("opt_arrays of a run in the module layout "
                                 "cannot seed a pipeline run (its moments "
                                 "are in the unpacked leaf order)")
            variables = pack_pipeline_params(variables, module.depth)
        layout = pipe_layout(variables["params"], self.mesh, heads)
        micro = config.sharding.pipeline_microbatches or 2 * n_pipe
        remat, mesh = config.sharding.pipeline_remat, self.mesh

        def train_apply(v, x, *, train: bool = False, generator=None):
            return pipeline_apply(module, v, x, mesh, microbatches=micro,
                                  train=train, generator=generator,
                                  remat=remat)

        def eval_apply(v, x, **kw):
            # the stages' layers gathered (model slices stay: the module
            # path head-shards under the mesh) and unpacked
            full = layout.gather_tree(v["params"], (pmesh.PIPE_AXIS,))
            return base(unpack_pipeline_params({"params": full}), x, **kw)

        return layout, train_apply, eval_apply, variables, opt_arrays

    # ------------------------------------------------------------------

    def request_preemption(self):
        """Ask the fit loop to checkpoint and exit at the next batch
        boundary (safe point).  Called from the SIGTERM handler fit()
        installs, or directly by a cluster manager integration."""
        self._preempt.set()

    def _preemption_agreed(self) -> bool:
        """Whether to preempt at this safe point (JAX :236): the local
        flag on one rank; under a mesh any rank's flag, agreed by an
        all-reduce, so every rank stops at the same batch (a rank that
        stopped while the others enter the gradient all-reduce would hang
        them)."""
        local = self._preempt.is_set()
        if self.mesh is None:
            return local
        import torch.distributed as dist
        flag = torch.tensor([float(local)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _barrier(self):
        """Under a mesh, wait for every rank (after rank 0's checkpoint
        saves, so no rank reads a directory mid-save)."""
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

    def fit(self, start_epoch: int = 0, start_batch: int = 0):
        """Run the training lifecycle (JAX :253).  ``start_epoch`` > 0
        resumes the epoch loop mid-horizon (the optimizer and schedule
        position live in the restored state); ``start_batch`` > 0 also
        starts the first epoch that many batches in (exact mid-epoch
        resume: the per-epoch orders are seeded, so the skipped prefix is
        exactly the batches already trained).  Returns the best
        validation metrics, with ``preempted=True`` after a preemption."""
        cfg = self.config
        stopper = EarlyStopping(cfg.early_stop.patience,
                                cfg.early_stop.min_delta,
                                cfg.early_stop.mode)
        best = {"val_f1": -1.0, "epoch": -1}
        # SIGTERM (the eviction signal) asks for a checkpoint at the next
        # batch boundary; the handler only sets a flag, the IO happens at
        # the safe point in the loop
        prev_handler = None
        hook = (self.checkpoints is not None
                and cfg.checkpoint.save_on_preemption
                and threading.current_thread() is threading.main_thread())
        # a stale request from a cancelled eviction must not make every
        # later fit() exit at batch 0 untrained
        self._preempt.clear()
        if hook:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda *_: self.request_preemption())
        try:
            return self._fit_loop(cfg, stopper, best, start_epoch,
                                  start_batch)
        finally:
            if hook:
                signal.signal(signal.SIGTERM, prev_handler)

    def _fit_loop(self, cfg, stopper, best, start_epoch=0, start_batch=0):
        try:
            return self._fit_epochs(cfg, stopper, best, start_epoch,
                                    start_batch)
        except _Preempted:
            if self.checkpoints:
                step = int(self.state.step)
                if step in self.checkpoints.all_steps():
                    # the request landed in the validate / best-save
                    # window: this state is on disk already, and a
                    # re-save would delete it first
                    log.warning("preemption requested — step %d is "
                                "already checkpointed; exiting", step)
                else:
                    log.warning("preemption requested — checkpointing "
                                "at step %d before exit", step)
                    # pinned: exempt from best-k retention (its val_f1
                    # ties the best checkpoints'); no optimal_threshold,
                    # which was validated on another (the best epoch's)
                    # model
                    self.checkpoints.save(
                        step, self.state,
                        metrics={"val_f1": best["val_f1"],
                                 "epoch": best["epoch"], "preempted": True},
                        config=cfg.to_dict(), pin=True,
                        data=self._data_position(step))
                self.checkpoints.wait_until_finished()
                self._barrier()
            return {**best, "preempted": True}

    def _data_position(self, step: int) -> dict:
        spe = max(self.steps_per_epoch, 1)
        return {"epoch": step // spe, "batch": step % spe,
                "steps_per_epoch": self.steps_per_epoch}

    def _fit_epochs(self, cfg, stopper, best, start_epoch=0, start_batch=0):
        for epoch in range(start_epoch, cfg.optim.num_epochs):
            if self._preemption_agreed():
                raise _Preempted
            t0 = time.time()
            # a profiler trace of the first epoch when configured
            with profile_trace(cfg.telemetry.profile_dir
                               if epoch == start_epoch else None):
                train_metrics = self.train_epoch(
                    epoch, skip_batches=start_batch if epoch == start_epoch
                    else 0)
            val_metrics = self.validate(epoch=epoch)
            summary = {
                "epoch": epoch, "epoch_time_s": time.time() - t0,
                "train/epoch": epoch,
                **{f"train/{k}": v for k, v in train_metrics.items()},
                **{f"val/{k}": v for k, v in val_metrics.items()},
            }
            self.logger.log(summary, step=int(self.state.step))

            val_f1 = float(val_metrics["f1"])
            # the validated operating point goes with the weights
            ckpt_metrics = {"val_f1": val_f1, "epoch": epoch}
            for k in ("optimal_threshold", "optimal_f1", "auc"):
                if k in val_metrics:
                    ckpt_metrics[k] = float(val_metrics[k])
            if cfg.optim.ema_decay is not None:
                ckpt_metrics["ema_decay"] = float(cfg.optim.ema_decay)
            step = int(self.state.step)
            if val_f1 > best["val_f1"]:
                # in place: the preemption path reads this dict
                best.clear()
                best.update({"val_f1": val_f1, "epoch": epoch,
                             **{k: float(v) for k, v in val_metrics.items()
                                if np.isscalar(v)}})
                if self.checkpoints:
                    self.checkpoints.save(
                        step, self.state, metrics=ckpt_metrics,
                        config=cfg.to_dict(),
                        data=self._data_position(step))
                    self._barrier()
            elif self.checkpoints and (
                    (epoch + 1) % cfg.checkpoint.save_every_epochs == 0):
                self.checkpoints.save(
                    step, self.state, metrics=ckpt_metrics,
                    config=cfg.to_dict(), data=self._data_position(step))
                self._barrier()

            if stopper.update(val_f1):
                log.info("early stopping at epoch %d (best %.4f @ %d)",
                         epoch, stopper.best_score, best["epoch"])
                break
        if self.checkpoints:
            # an async save may still be writing: fit() must not return
            # before the checkpoint a caller will read exists
            self.checkpoints.wait_until_finished()
            self._barrier()
        return best

    # ------------------------------------------------------------------

    def train_epoch(self, epoch: int, skip_batches: int = 0):
        """One epoch of train steps; returns the mean loss and accuracy.
        Metrics are read one step behind, so the host never waits on the
        step it just queued."""
        meters = {"loss": 0.0, "accuracy": 0.0}
        count = 0
        pending = None
        step0 = int(self.state.step)
        t_last = time.perf_counter()
        batches = self.train_batches(epoch, skip=skip_batches)
        for i, batch in enumerate(batches):
            if self._preemption_agreed():
                raise _Preempted         # safe point: between queued steps
            batch = dict(batch)
            group = batch.pop("group", None)
            try:
                # an unknown tag must fail loudly: training it through
                # another group's chain would corrupt the run quietly
                step_fn = self.train_steps[group]
            except KeyError:
                raise KeyError(
                    f"batch tagged group={group!r} but batch_prep only "
                    f"defines {sorted(map(str, self.train_steps))}")
            prev = pending
            self.state, pending = step_fn(self.state, batch)
            if prev is not None:
                self._accumulate(meters, prev)
                count += 1
            if ((i + 1) % self.config.telemetry.log_interval == 0
                    and prev is not None):
                now = time.perf_counter()
                step = step0 + i - 1      # prev is the previous batch's
                record = {
                    "train/loss": float(prev["loss"]),
                    "train/acc": float(prev["accuracy"]),
                    # the LR the optimizer applied at that micro-step
                    "train/lr": float(self.lr_schedule(step // self._accum)),
                    "train/grad_norm": float(prev["grad_norm"]),
                    "train/steps_per_sec": (self.config.telemetry.log_interval
                                            / max(now - t_last, 1e-9)),
                }
                t_last = now
                if self.device.type == "cuda":
                    record["train/device_mem_gb"] = (
                        torch.cuda.max_memory_allocated(self.device) / 2**30)
                self.logger.log(record, step=step)
        if pending is not None:
            self._accumulate(meters, pending)
            count += 1
        return {k: v / max(count, 1) for k, v in meters.items()}

    @staticmethod
    def _accumulate(meters, metrics):
        for k in meters:
            meters[k] += float(metrics[k])

    # ------------------------------------------------------------------

    def validate(self, epoch: Optional[int] = None):
        """Eval pass and metrics on the card (JAX :506): the val loss, the
        reference's per-phase W&B block at threshold 0.5
        (train_advanced.py:411-427), AUC, and with ``threshold.optimize``
        the 41-point sweep, every point logged as ``threshold_sweep/*``
        (:267-275), and its best-F1 operating point (:449-462).  With EMA
        on, the EMA shadow is validated (the weights that would deploy)."""
        eval_params = self.state.params
        if self.config.optim.ema_decay is not None:
            ema = find_ema_params(self.state)
            if ema is not None:
                eval_params = ema
        scores, labels, loss_sum = [], [], None
        n_seen = 0
        for batch in self.val_batches():
            images = _to(batch["image"], self.device)
            lbl = _to(batch["label"], self.device).long()
            b = images.shape[0]
            out = self.eval_step(eval_params, images)
            # the loss stays on the card until after the loop
            batch_loss = self._eval_loss(out["logits"][:b].float(), lbl) * b
            loss_sum = batch_loss if loss_sum is None else loss_sum + batch_loss
            n_seen += b
            scores.append(out["score"][:b])
            labels.append(lbl)
        scores = torch.cat(scores)
        labels = torch.cat(labels)
        if self.mesh is not None:
            # every data rank's scores, in rank order: the metrics below
            # are the whole validation set's, the same on every rank
            import torch.distributed as dist

            from ..parallel.collectives import all_gather_rows
            group = self.mesh.get_group(pmesh.DATA_AXIS)
            scores = all_gather_rows(scores, group)
            labels = all_gather_rows(labels, group)
            sums = torch.stack([loss_sum.detach().float(), torch.tensor(
                float(n_seen), device=loss_sum.device)])
            dist.all_reduce(sums, group=group)
            loss_sum, n_seen = sums[0], int(sums[1].item())

        table = dmetrics.threshold_table(
            scores, labels, torch.tensor([0.5], device=scores.device))
        out = {
            "loss": float(loss_sum) / max(n_seen, 1),
            "accuracy": table["accuracy"][0],
            "precision": table["precision"][0],
            "recall": table["recall"][0],
            "f1": table["f1_score"][0],
            "auc": dmetrics.auc(scores, labels),
            "specificity": table["specificity"][0],
            "npv": table["npv"][0],
            "tp": table["tp"][0], "tn": table["tn"][0],
            "fp": table["fp"][0], "fn": table["fn"][0],
            "far": table["far"][0],
            "frr": table["frr"][0],
        }
        if epoch is not None:
            out["epoch"] = epoch
        if self.config.threshold.optimize:
            t = self.config.threshold
            grid = dmetrics.threshold_grid(t.t_min, t.t_max, t.steps,
                                           scores.device)
            sweep = dmetrics.threshold_table(scores, labels, grid)
            sweep = {k: v.cpu().numpy() for k, v in sweep.items()}
            for i in range(len(grid)):
                self.logger.log({
                    "threshold_sweep/threshold": float(sweep["threshold"][i]),
                    "threshold_sweep/accuracy": float(sweep["accuracy"][i]),
                    "threshold_sweep/precision": float(sweep["precision"][i]),
                    "threshold_sweep/recall": float(sweep["recall"][i]),
                    "threshold_sweep/f1": float(sweep["f1_score"][i]),
                })
            bi = int(np.argmax(sweep["f1_score"]))
            out.update({
                "optimal_threshold": sweep["threshold"][bi],
                "optimal_accuracy": sweep["accuracy"][bi],
                "optimal_precision": sweep["precision"][bi],
                "optimal_recall": sweep["recall"][bi],
                "optimal_f1": sweep["f1_score"][bi],
                "optimal_specificity": sweep["specificity"][bi],
                "optimal_far": sweep["far"][bi],
                "optimal_frr": sweep["frr"][bi],
                "optimal_tp": sweep["tp"][bi],
                "optimal_tn": sweep["tn"][bi],
                "optimal_fp": sweep["fp"][bi],
                "optimal_fn": sweep["fn"][bi],
            })
        return {k: float(v) for k, v in out.items()}
