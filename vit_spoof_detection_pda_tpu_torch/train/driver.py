"""Config -> full training run (counterpart of the JAX package's
``train/driver.py``: the reference's ``train()`` lifecycle,
train_advanced.py:492-693, as a library function).

Pipeline: scan the augmented store (or, online, the raw store and its
differential fan-out) -> class counts -> stratified split -> host decode
-> the train-time augmentation chain inside the train step on the card
(``make_prep_fn``: uint8 -> [0, 1] in the augmentation dtype -> the chain
-> ImageNet-normalized f32) -> the train step -> validation with metrics
on the card -> checkpoints and early stop.  The chain builders take the
``TrainAugConfig`` fields as keyword arguments with its defaults;
:func:`train_from_config` maps a ``Config`` onto them.

Several ranks (``parallel/mesh.py``, one process each): the records are
shared out by data rank (``data/loader.py::shard_for_host``; the pool
mode stages every original on each rank and shares out its index
batches instead), each rank's batches are its rows of the global batch
and the Trainer trains on the mesh ``config.sharding`` describes.
``data.shard_cache`` (the memmapped shard store) is not ported and
raises.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..augment.policy import CHAINS, train_time_chain
from ..ops import augment as A
from ..ops import image as I

log = logging.getLogger(__name__)

_SHARD_TODO = ("data.shard_cache (the memmapped shard store) is not "
               "ported: ROADMAP Queue 1 item 5")

# TrainAugConfig's defaults (the JAX package's config.py)
TRAIN_AUG = dict(crop_size=224, hflip_prob=0.5,
                 color_jitter=(0.2, 0.2, 0.2, 0.1), rotation_deg=10.0,
                 random_erase_prob=0.25)


def _aug_dtype(aug_dtype: str) -> torch.dtype:
    return torch.float32 if aug_dtype == "float32" else torch.bfloat16


def make_prep_fn(chain, *, aug_dtype: str = "bfloat16"):
    """``prep(generator, uint8 [B, S, S, 3]) -> normalized f32``: the chain
    computes in ``aug_dtype`` (bf16 by default); normalization and the
    output are f32."""
    dtype = _aug_dtype(aug_dtype)

    def prep(gen, batch_u8):
        x = I.to_float(batch_u8).to(dtype)
        x = A.apply_chain(gen, x, chain)
        return I.normalize(x.float())

    return prep


def _train_chain(*, crop: bool = True, **train_aug):
    """The torchvision train-time chain from the ``TrainAugConfig``
    fields (``crop=False``: inputs already at size)."""
    ta = {**TRAIN_AUG, **train_aug}
    return train_time_chain(
        crop_size=ta["crop_size"] if crop else None,
        hflip_prob=ta["hflip_prob"], color_jitter=ta["color_jitter"],
        rotation_deg=ta["rotation_deg"],
        random_erase_prob=ta["random_erase_prob"])


def make_train_aug_fn(*, aug_dtype: str = "bfloat16", **train_aug):
    """uint8 ``[B, 256, 256, 3]`` -> augmented normalized f32 ``[B, 224,
    224, 3]`` (the standalone form of the prep of the default chain)."""
    return make_prep_fn(_train_chain(**train_aug), aug_dtype=aug_dtype)


def make_eval_prep_fn():
    """uint8 -> normalized f32, no augmentation."""
    def run(batch_u8):
        return I.normalize(I.to_float(batch_u8)).float()

    return run


def group_chains(*, enabled: bool = True, **train_aug) -> dict:
    """The online and pool modes' chain per severity group: originals get
    the train-time chain without the crop (inputs are already at size),
    each tier its chain plus the same train-time ops (the reference
    re-randomizes its stored copies every epoch)."""
    orig = _train_chain(crop=False, **train_aug) if enabled else []
    chains = {"orig": orig}
    for g in ("heavy", "medium", "light"):
        chains[g] = CHAINS[g]() + orig
    return chains


def make_group_preps(*, aug_dtype: str = "bfloat16", enabled: bool = True,
                     **train_aug) -> dict:
    """``{group: batch_prep}`` over :func:`group_chains`."""
    return {g: make_prep_fn(chain, aug_dtype=aug_dtype)
            for g, chain in group_chains(enabled=enabled,
                                         **train_aug).items()}


# --------------------------------------------------------------------------
# Config -> training run
# --------------------------------------------------------------------------


def _train_aug(cfg) -> dict:
    """The ``TrainAugConfig`` fields the chain builders take."""
    ta = cfg.train_aug
    return dict(crop_size=ta.crop_size, hflip_prob=ta.hflip_prob,
                color_jitter=tuple(ta.color_jitter),
                rotation_deg=ta.rotation_deg,
                random_erase_prob=ta.random_erase_prob)


def _make_online_data(cfg, mesh=None):
    """Online differential augmentation (JAX ``_make_online_data``): raw
    store -> severity groups decoded on the host -> each group's chain
    inside the step."""
    from ..data.manifest import class_counts, scan_raw, stratified_split
    from .online import OnlineAugmentedData

    from ..data.loader import shard_for_host

    records = scan_raw(cfg.augment.input_dir)
    if not records:
        raise FileNotFoundError(
            f"online augmentation: no images under {cfg.augment.input_dir}")
    records = shard_for_host(records, mesh)
    train_recs, val_recs = stratified_split(
        records, cfg.data.train_split, cfg.data.split_seed)
    data = OnlineAugmentedData(
        train_recs, live_mult=cfg.augment.live_augmentations,
        spoof_mult=cfg.augment.spoof_augmentations,
        batch_size=cfg.data.batch_size, img_size=cfg.data.img_size,
        num_workers=cfg.data.num_workers,
        prefetch_depth=cfg.data.prefetch_depth, seed=cfg.seed)
    # class weights of the stream the loss sees: the expanded fan-out
    counts = class_counts([r for rs in data.groups.values() for r in rs])
    preps = make_group_preps(aug_dtype=cfg.train_aug.aug_dtype,
                             enabled=cfg.train_aug.enabled, **_train_aug(cfg))

    def train_batches(epoch, skip=0):
        for g, batch in data.batches(epoch, skip=skip):
            yield {"image": batch["image"], "label": batch["label"],
                   "group": g}

    return train_batches, val_recs, data.steps_per_epoch, counts, preps


def _make_pool_data(cfg, device, mesh=None):
    """Online differential augmentation from a pool of the originals on
    the card (JAX ``_make_pool_data``): decode the unique originals once,
    stage them, feed the epoch as per-group index batches.  Under a mesh
    every rank stages the same pool and takes its data rank's rows of
    each index batch; validation streams this rank's share."""
    from concurrent.futures import ThreadPoolExecutor

    from ..data.loader import decode_image, shard_for_host
    from ..data.manifest import scan_raw, stratified_split
    from .pool import DevicePoolData

    records = scan_raw(cfg.augment.input_dir)
    if not records:
        raise FileNotFoundError(
            f"online augmentation: no images under {cfg.augment.input_dir}")
    train_recs, val_recs = stratified_split(
        records, cfg.data.train_split, cfg.data.split_seed)
    size = cfg.data.img_size
    with ThreadPoolExecutor(max(1, cfg.data.num_workers)) as pool:
        imgs = list(pool.map(lambda r: decode_image(r.path, size, "exact"),
                             train_recs))
    labels = np.asarray([r.label for r in train_recs], np.int32)
    lm, sm = cfg.augment.live_augmentations, cfg.augment.spoof_augmentations
    data = DevicePoolData(np.stack(imgs), labels, live_mult=lm,
                          spoof_mult=sm, batch_size=cfg.data.batch_size,
                          seed=cfg.seed, device=device)
    n_live = int(np.sum(labels == 1))
    counts = ((len(labels) - n_live) * (1 + sm), n_live * (1 + lm))
    preps = {g: data.wrap_prep(p) for g, p in make_group_preps(
        aug_dtype=cfg.train_aug.aug_dtype, enabled=cfg.train_aug.enabled,
        **_train_aug(cfg)).items()}
    def train_batches(epoch, skip=0):
        for batch in data.batches(epoch, skip=skip):
            if mesh is not None:
                from ..parallel.mesh import shard_batch
                rows = shard_batch({"index": batch["index"],
                                    "label": batch["label"]}, mesh)
                batch = {**batch, **rows}
            yield batch

    return (train_batches, shard_for_host(val_recs, mesh),
            data.steps_per_epoch, counts, preps)


def _run_training(cfg, train_batches, val_recs, steps, counts,
                  max_steps_per_epoch, batch_prep=None, device=None,
                  mesh=None):
    """Shared tail (JAX :221): the validation pipeline, the model, the
    checkpoints, the Trainer, resume; returns ``(best, trainer)``."""
    from ..data.loader import DataPipeline
    from ..models.convert import antispoof_from_torch
    from ..models.registry import (build_model, build_vit_from_config,
                                   geometry_mismatches)
    from ..utils.checkpoint import CheckpointManager
    from .trainer import Trainer

    val_pipe = DataPipeline(
        val_recs, batch_size=cfg.data.eval_batch_size,
        img_size=cfg.data.img_size, resize="exact",
        num_workers=cfg.data.num_workers, drop_last=False)
    prep_fn = make_eval_prep_fn()
    from ..device import resolve_device
    dev = resolve_device(device)

    def val_batches():
        for b in val_pipe.batches():
            yield {"image": prep_fn(torch.from_numpy(b["image"]).to(dev)),
                   "label": b["label"]}

    if max_steps_per_epoch is not None:
        steps = min(steps, max_steps_per_epoch)
        inner = train_batches

        def train_batches(epoch, skip=0):             # noqa: F811
            budget = max(0, max_steps_per_epoch - skip)
            for i, item in enumerate(inner(epoch, skip=skip)):
                if i >= budget:
                    break
                yield item

    dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
             else torch.float32)
    module = build_vit_from_config(cfg.model, dtype,
                                   img_size=cfg.data.img_size)
    variables = None
    if cfg.model.pretrained_path:
        loaded = build_model(
            "Custom_ViT_FineTuned",
            checkpoint_path=cfg.model.pretrained_path,
            dropout=cfg.model.dropout, dtype=dtype,
            img_size=cfg.data.img_size, device="cpu")
        variables = antispoof_from_torch(loaded.state_dict())
        structure_err, mismatched = geometry_mismatches(
            antispoof_from_torch(module.state_dict()), variables)
        if structure_err or mismatched:
            raise ValueError(
                "model.pretrained_path loads the flagship "
                "Custom_ViT_FineTuned architecture, but cfg.model "
                "describes a different parameter tree — drop the "
                "non-default model geometry or convert the checkpoint "
                "explicitly (models.convert)")

    if cfg.checkpoint.keep_best_by != "val_f1":
        log.warning(
            "checkpoint.keep_best_by=%r but Trainer saves record only "
            "val_f1 — best-k retention will treat all checkpoints as "
            "ties", cfg.checkpoint.keep_best_by)
    ckpt = CheckpointManager(
        cfg.checkpoint.save_dir, max_to_keep=cfg.checkpoint.max_to_keep,
        best_metric=cfg.checkpoint.keep_best_by,
        async_save=cfg.checkpoint.async_save)
    trainer = Trainer(cfg, module, train_batches=train_batches,
                      val_batches=val_batches, steps_per_epoch=steps,
                      class_counts=counts, variables=variables,
                      checkpoints=ckpt, batch_prep=batch_prep, device=dev,
                      mesh=mesh)
    start_epoch = start_batch = 0
    if cfg.checkpoint.resume:
        latest = ckpt.latest_step()
        if latest is None:
            log.info("checkpoint.resume: no checkpoint in %s — fresh run",
                     cfg.checkpoint.save_dir)
        else:
            # the full state: params, optimizer, schedule position, seed;
            # the epoch loop resumes where the step count says, a
            # mid-epoch preemption checkpoint at its batch
            trainer.state = ckpt.restore(trainer.state)
            step = int(trainer.state.step)
            start_epoch = min(step // max(steps, 1), cfg.optim.num_epochs)
            if start_epoch < cfg.optim.num_epochs:
                start_batch = step % max(steps, 1)
            log.info("resumed from step %d (%s) -> starting at epoch %d"
                     " batch %d", latest, cfg.checkpoint.save_dir,
                     start_epoch, start_batch)
    best = trainer.fit(start_epoch=start_epoch, start_batch=start_batch)
    log.info("training done: best %s", best)
    return best, trainer


def train_from_config(cfg, *, mesh=None, records=None,
                      max_steps_per_epoch: Optional[int] = None,
                      device=None):
    """Run the full training lifecycle (JAX :328); returns ``(best,
    trainer)``, as JAX's does.  On the card unless ``device="cpu"``; in a
    process group of more than one rank, on the mesh ``cfg.sharding``
    describes (or ``mesh``)."""
    from ..data.loader import DataPipeline, shard_for_host
    from ..data.manifest import class_counts, scan_augmented, stratified_split
    from .trainer import resolve_mesh

    mesh = resolve_mesh(cfg, mesh, device)
    if cfg.data.shard_cache:
        raise NotImplementedError(_SHARD_TODO)
    if cfg.augment.online:
        if cfg.augment.device_pool:
            from ..device import resolve_device
            parts = _make_pool_data(cfg, resolve_device(device), mesh)
        else:
            parts = _make_online_data(cfg, mesh)
        train_batches, val_recs, steps, counts, preps = parts
        return _run_training(cfg, train_batches, val_recs, steps, counts,
                             max_steps_per_epoch, batch_prep=preps,
                             device=device, mesh=mesh)
    if records is None:
        records = scan_augmented(cfg.data.data_root)
    if not records:
        raise FileNotFoundError(
            f"no images found under {cfg.data.data_root} "
            "(expected live/ and spoof/ subdirectories)")
    records = shard_for_host(records, mesh)
    counts = class_counts(records)
    log.info("dataset: %d images (spoof=%d live=%d)", len(records),
             counts[0], counts[1])
    train_recs, val_recs = stratified_split(
        records, cfg.data.train_split, cfg.data.split_seed)
    aug_on = cfg.train_aug.enabled
    train_pipe = DataPipeline(
        train_recs, batch_size=cfg.data.batch_size,
        img_size=cfg.train_aug.resize_to if aug_on else cfg.data.img_size,
        resize="shorter" if aug_on else "exact",
        num_workers=cfg.data.num_workers,
        prefetch_depth=cfg.data.prefetch_depth, shuffle=True,
        drop_last=cfg.data.drop_last_train, seed=cfg.seed)

    def train_batches(epoch, skip=0):
        for b in train_pipe.batches(epoch, skip=skip):
            yield {"image": b["image"], "label": b["label"]}

    chain = _train_chain(**_train_aug(cfg)) if aug_on else []
    prep = make_prep_fn(chain, aug_dtype=cfg.train_aug.aug_dtype)
    return _run_training(cfg, train_batches, val_recs,
                         train_pipe.steps_per_epoch, counts,
                         max_steps_per_epoch, batch_prep=prep, device=device,
                         mesh=mesh)
