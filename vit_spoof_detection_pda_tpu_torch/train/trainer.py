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

One card: a mesh, FSDP and the pipeline are not ported and raise.
``telemetry.profile_dir`` traces the first epoch with ``torch.profiler``
(``utils/profiling.py``).
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
from ..utils.checkpoint import CheckpointManager
from ..utils.profiling import profile_trace
from ..utils.telemetry import MetricLogger
from .early_stop import EarlyStopping
from .schedule import make_lr_schedule
from .state import create_train_state, find_ema_params, make_optimizer
from .step import _to, make_eval_step, make_train_step

log = logging.getLogger(__name__)

_PARALLEL_TODO = (
    "{what} is not ported: the port trains on one card (ROADMAP Queue 1 "
    "item 9, parallelism)")


class _Preempted(Exception):
    """Raised at a safe point (a batch boundary) after a preemption
    request; the fit loop checkpoints and returns."""


def check_single_device(config: Config, mesh=None):
    """Raise ``NotImplementedError`` for what needs more than one card: a
    mesh, data / model / sequence / pipeline parallelism, FSDP."""
    sh = config.sharding
    if mesh is not None:
        raise NotImplementedError(_PARALLEL_TODO.format(what="a device mesh"))
    for field in ("model_parallel", "seq_parallel", "pipeline_parallel"):
        if getattr(sh, field) > 1:
            raise NotImplementedError(_PARALLEL_TODO.format(
                what=f"sharding.{field}={getattr(sh, field)}"))
    if sh.data_parallel > 1:
        raise NotImplementedError(_PARALLEL_TODO.format(
            what=f"sharding.data_parallel={sh.data_parallel}"))
    if sh.fsdp:
        raise NotImplementedError(_PARALLEL_TODO.format(
            what="sharding.fsdp"))


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
        check_single_device(config, mesh)
        self.config = config
        self.module = module
        self.train_batches = train_batches
        self.val_batches = val_batches
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self._preempt = threading.Event()
        self.logger = logger or MetricLogger(
            jsonl_path=config.telemetry.jsonl_path,
            wandb_project=config.telemetry.wandb_project,
            wandb_entity=config.telemetry.wandb_entity,
            config=config.to_dict())
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

        # the train step's forward: the fused training forward over the
        # kernels (JAX make_apply; model.mlp_vjp picks the MLP backward),
        # or the module path; validation always runs the module path
        from ..models.fasttrain import fast_apply_available, make_apply
        if config.model.fused_train_forward and fast_apply_available(module):
            train_apply = make_apply(module, mlp_mode=config.model.mlp_vjp)
        else:
            train_apply = module_tree_apply(module)
        self.state = create_train_state(
            module, tx, config.seed, variables=variables,
            apply_fn=train_apply, device=self.device, opt_arrays=opt_arrays)
        self._eval_loss = loss_fn

        # batch_prep: on-card augmentation inside the step (a callable, or
        # {group_tag: callable} for the severity groups; batches then
        # carry a "group" key selecting their step)
        preps = (batch_prep if isinstance(batch_prep, dict)
                 else {None: batch_prep})
        self.train_steps = {tag: make_train_step(loss_fn, batch_prep=prep)
                            for tag, prep in preps.items()}
        self.eval_step = make_eval_step(module_tree_apply(module))

    # ------------------------------------------------------------------

    def request_preemption(self):
        """Ask the fit loop to checkpoint and exit at the next batch
        boundary (safe point).  Called from the SIGTERM handler fit()
        installs, or directly by a cluster manager integration."""
        self._preempt.set()

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
            return {**best, "preempted": True}

    def _data_position(self, step: int) -> dict:
        spe = max(self.steps_per_epoch, 1)
        return {"epoch": step // spe, "batch": step % spe,
                "steps_per_epoch": self.steps_per_epoch}

    def _fit_epochs(self, cfg, stopper, best, start_epoch=0, start_batch=0):
        for epoch in range(start_epoch, cfg.optim.num_epochs):
            if self._preempt.is_set():
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
            elif self.checkpoints and (
                    (epoch + 1) % cfg.checkpoint.save_every_epochs == 0):
                self.checkpoints.save(
                    step, self.state, metrics=ckpt_metrics,
                    config=cfg.to_dict(), data=self._data_position(step))

            if stopper.update(val_f1):
                log.info("early stopping at epoch %d (best %.4f @ %d)",
                         epoch, stopper.best_score, best["epoch"])
                break
        if self.checkpoints:
            # an async save may still be writing: fit() must not return
            # before the checkpoint a caller will read exists
            self.checkpoints.wait_until_finished()
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
            if self._preempt.is_set():
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
