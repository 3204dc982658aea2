"""Typed configuration tree with presets and file/CLI/env overrides.

Replaces the reference's per-script ``class Config`` blocks
(reference: train_advanced.py:26-86, test.py:44-67, augment_data.py:27-47,
simple/train.py:27-75) with one dataclass tree.  Presets reproduce each
reference script's defaults so published behavior is recoverable; overrides
hook into the same tree (the reference's wandb-sweep override mechanism,
train_advanced.py:498-505, maps onto ``Config.with_overrides``).

The port's copy of the JAX package's ``config.py`` (stdlib only): the same
fields, defaults, presets and JSON form, so one config file drives both
packages.  Every sharding layout runs: data and sequence meshes, a model
axis (``sharding.model_parallel > 1``), ``sharding.fsdp`` and the pipeline
(``sharding.pipeline_parallel > 1``, alone or with a model axis);
``data.shard_cache`` feeds training from the shard store, and
``telemetry.profile_dir`` is honoured (a trace of the first epoch).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Optional, Tuple


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


class _Base:
    """Shared helpers for every config node."""

    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    def with_overrides(self, overrides: dict[str, Any]) -> "Any":
        """Return a copy with dotted-path overrides applied.

        ``{"optim.learning_rate": 1e-5, "model.dropout": 0.2}`` — the same
        role the reference's ``wandb.config.get(...)`` fallbacks play
        (train_advanced.py:498-505).
        """
        out = self
        for key, value in overrides.items():
            out = _set_path(out, key.split("."), value)
        return out

    @classmethod
    def from_dict(cls, d: dict):
        proto = cls()  # every config node is constructible with defaults
        kwargs = {}
        for f in fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            default = getattr(proto, f.name)
            if is_dataclass(default) and isinstance(v, dict):
                kwargs[f.name] = type(default).from_dict(v)
            elif isinstance(default, tuple) and isinstance(v, list):
                # JSON has no tuples; restore tuple-typed fields.
                kwargs[f.name] = tuple(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json_file(cls, path: str):
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _set_path(node, path, value):
    if len(path) == 1:
        return dataclasses.replace(node, **{path[0]: value})
    child = getattr(node, path[0])
    return dataclasses.replace(node, **{path[0]: _set_path(child, path[1:], value)})


# --------------------------------------------------------------------------
# Leaf configs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig(_Base):
    """Dataset scanning / split / loading (reference L0)."""

    data_root: str = "./augmented_images"
    raw_root: str = "./celeba_spoof"          # subject/{live,spoof}/*.png layout
    test_root: str = "./test_split"
    train_split: float = 0.85                  # train_advanced.py:29-30
    split_seed: int = 42                       # train_advanced.py:543
    img_size: int = 224
    batch_size: int = 128                      # train_advanced.py:38
    eval_batch_size: int = 256                 # train_advanced.py:565
    num_workers: int = 8                       # host decode threads
    prefetch_depth: int = 4                    # double-buffered device puts
    drop_last_train: bool = True
    # Pre-decoded uint8 shard cache (data/shards.py): decode the train
    # store ONCE into memmapped .npy shards here; subsequent epochs (and
    # runs) read memory instead of re-decoding ~115k JPEGs per epoch.
    # None = decode per epoch through the threaded pipeline (reference
    # behavior, train_advanced.py:554-573).
    shard_cache: Optional[str] = None
    # Label convention: canonical internal convention is 1 = live
    # (train/test stack, test.py:117); the cross-model harness view flips to
    # 0 = live / 1 = spoof (evaluate_all_models.py:38-42) via an adapter.
    live_label: int = 1


@dataclass(frozen=True)
class ModelConfig(_Base):
    """Backbone + head (reference L2, train_advanced.py:187-204)."""

    name: str = "vit_base_patch16_224"
    pretrained: bool = True
    pretrained_path: Optional[str] = None      # local safetensors/npz/pth
    num_classes: int = 2
    dropout: float = 0.1
    head_hidden: int = 512                     # Linear(768->512) in the head
    # ViT-B/16 architecture facts (fixed by the reference model name)
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    # Compute policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"            # "bfloat16" | "float32"
    # "erf" = torch nn.GELU parity (reference numerics); "tanh" = serving
    # fast path, ~1 bf16 ulp apart, +24% inference throughput
    gelu: str = "erf"
    # Fused-block training forward (models/fasttrain.py): each pre-LN
    # attention sub-layer runs as one training attention-block kernel in
    # the train step's forward, with a recompute-free backward over
    # residuals padded to 8 rows.  False: the module path (kernel 8 and
    # its backward).
    fused_train_forward: bool = True
    # MLP VJP strategy under the fused forward: "hidden" = stored-hidden
    # backward with the LN/residual backward kernel (the default);
    # "autodiff" = plain ops with gelu_lean; "xhat" = memory-lean
    # recompute backward (~150 MB/layer fewer residuals); "fused" = the
    # whole-MLP training kernel's forward under the "hidden" backward.
    mlp_vjp: str = "hidden"


@dataclass(frozen=True)
class LossConfig(_Base):
    """Loss factory inputs (train_advanced.py:299-312)."""

    loss_type: str = "focal"                   # "ce" | "focal" | "weighted_ce"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    label_smoothing: float = 0.0               # simple/train.py:45 uses 0.1
    use_class_weights: bool = False            # weighted_ce computes from manifest


@dataclass(frozen=True)
class OptimConfig(_Base):
    """AdamW + cosine schedule (train_advanced.py:592-607)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    num_epochs: int = 50
    warmup_epochs: int = 3
    # The reference computes warmup_steps but never applies a warmup ramp —
    # the cosine schedule simply runs over (total - warmup) steps at full LR
    # (train_advanced.py:599-607). `true_warmup=False` reproduces that;
    # True enables a real linear warmup ramp.
    true_warmup: bool = False
    min_lr: float = 1e-6
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    # Polyak/EMA shadow weights (train/state.py::ema_of_params): None =
    # off (reference behavior).  When set (e.g. 0.999), validation and
    # best-checkpoint selection run on the EMA weights — the standard
    # production-serving average — and `export --ema` /
    # `load_checkpoint_bundle(ema=True)` retrieve them.
    ema_decay: Optional[float] = None


@dataclass(frozen=True)
class ThresholdConfig(_Base):
    """Validation threshold sweep (train_advanced.py:239-278)."""

    optimize: bool = True
    t_min: float = 0.3
    t_max: float = 0.7
    steps: int = 41


@dataclass(frozen=True)
class EarlyStopConfig(_Base):
    patience: int = 10
    min_delta: float = 1e-3
    mode: str = "max"                          # on val F1


@dataclass(frozen=True)
class CheckpointConfig(_Base):
    save_dir: str = "./checkpoints_advanced"
    save_every_epochs: int = 10                # train_advanced.py:667-672
    keep_best_by: str = "val_f1"
    max_to_keep: int = 3
    async_save: bool = False                   # background-thread writes
    save_on_preemption: bool = True            # SIGTERM -> checkpoint+exit
    resume: bool = False                       # restore latest from save_dir


@dataclass(frozen=True)
class AugmentConfig(_Base):
    """Differential augmentation policy (augment_data.py:27-47, 51-107)."""

    input_dir: str = "./celeba_spoof"
    output_dir: str = "./augmented_images"
    live_augmentations: int = 8
    spoof_augmentations: int = 2
    batch_size: int = 64
    img_size: int = 224
    save_quality: int = 95
    # Online mode streams augmented batches straight into training instead
    # of materializing JPEGs (offline reproduces
    # the reference's disk pipeline).
    online: bool = False
    # With online mode: stage the unique original images in device HBM
    # once and feed the epoch as [B] int32 index streams (train/pool.py)
    # — removes the ~19 MB/step host->device image upload; the pool
    # (~4 GB uint8 at the reference's ~27k-original scale) must fit
    # per-chip HBM alongside model+optimizer state.
    device_pool: bool = False


@dataclass(frozen=True)
class TrainAugConfig(_Base):
    """Per-batch training-time augmentation (train_advanced.py:166-177)."""

    resize_to: int = 256
    crop_size: int = 224
    hflip_prob: float = 0.5
    color_jitter: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.1)
    rotation_deg: float = 10.0
    random_erase_prob: float = 0.25
    # simple/train.py:164-175 variant: jitter 0.3 / rotation 15
    enabled: bool = True
    # dtype the on-device chain computes in.  bfloat16 (default) halves
    # the augmentation's VPU/HBM traffic; images are uint8-sourced and
    # the model consumes bf16 anyway, so the only loss is sub-quantum
    # rounding during intermediate aug math.  Set "float32" for exact
    # torchvision-float parity.
    aug_dtype: str = "bfloat16"


@dataclass(frozen=True)
class ShardingConfig(_Base):
    """Device-mesh layout (new capability; reference is single-device).

    Consumed by ``parallel.mesh_from_config`` and the Trainer:
    ``model_parallel > 1`` builds a (data, model) mesh and lays the
    parameters out with the Megatron TP specs; ``seq_parallel > 1``
    builds a (data, seq) mesh (attention dispatches to the
    all-gather-KV context-parallel kernel); ``pipeline_parallel > 1``
    builds a (data, pipe[, model]) mesh and routes the train forward
    through the GPipe schedule (parallel/pipeline.py — composes with
    model_parallel: Megatron TP inside each stage); ``fsdp=True``
    shards each large parameter leaf (and thus the Adam moments) over
    the data axis, ZeRO-3-style.  seq parallelism is exclusive with
    model/pipeline; fsdp composes with pure DP only.
    """

    # mesh axis NAMES are fixed package-wide (parallel.mesh.DATA_AXIS /
    # MODEL_AXIS / SEQ_AXIS / pipeline.PIPE_AXIS) — the attention
    # dispatch and the TP/FSDP spec tables key on them, so they are
    # deliberately not configurable
    data_parallel: int = -1                    # -1: all remaining devices
    model_parallel: int = 1                    # tensor-parallel axis size
    seq_parallel: int = 1                      # sequence/context-parallel
    pipeline_parallel: int = 1                 # GPipe stage count
    pipeline_microbatches: int = 0             # 0: auto (2 * stages)
    pipeline_remat: bool = False               # recompute block interiors
                                               # in backward (activation
                                               # memory ~ M x depth/S
                                               # otherwise)
    fsdp: bool = False                         # ZeRO-3 param/opt layout
    fsdp_min_size: int = 2 ** 16               # leaves below stay replicated


@dataclass(frozen=True)
class TelemetryConfig(_Base):
    log_interval: int = 10                     # steps between metric emits
    jsonl_path: Optional[str] = None           # structured metric stream
    wandb_project: Optional[str] = None        # optional W&B sink (if installed)
    wandb_entity: Optional[str] = None
    profile_dir: Optional[str] = None          # profiler trace output


@dataclass(frozen=True)
class EvalConfig(_Base):
    """Evaluation + artifact writing (test.py:44-67, evaluate_all_models.py)."""

    output_dir: str = "./test_results"
    checkpoint_path: Optional[str] = None
    thresholds: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    extra_cm_thresholds: Tuple[float, ...] = (0.5, 0.7)  # confusion_matrices.json
    batch_size: int = 128


# --------------------------------------------------------------------------
# Root config
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Config(_Base):
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    threshold: ThresholdConfig = field(default_factory=ThresholdConfig)
    early_stop: EarlyStopConfig = field(default_factory=EarlyStopConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    train_aug: TrainAugConfig = field(default_factory=TrainAugConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    seed: int = 42

    @classmethod
    def preset(cls, name: str) -> "Config":
        return PRESETS[name]()

    def with_env_overrides(self, prefix: str = "PAD_") -> "Config":
        """Apply `PAD_optim__learning_rate=...`-style env overrides."""
        overrides = {}
        for key, raw in os.environ.items():
            if not key.startswith(prefix):
                continue
            path = key[len(prefix):].lower().replace("__", ".")
            try:
                overrides[path] = json.loads(raw)
            except json.JSONDecodeError:
                overrides[path] = raw
        out = self
        for path, value in overrides.items():
            try:
                out = _set_path(out, path.split("."), value)
            except (AttributeError, TypeError):
                # the env namespace is shared — an unrelated PAD_* var must
                # not crash config construction (with_overrides stays strict)
                import logging
                logging.getLogger(__name__).warning(
                    "ignoring env override %s%s: no config field %r",
                    prefix, path.replace(".", "__").upper(), path)
        return out


# --------------------------------------------------------------------------
# Presets — one per reference entry point
# --------------------------------------------------------------------------


def _advanced_train() -> Config:
    """train_advanced.py defaults (its Config block, lines 26-86)."""
    return Config()


def _simple_train() -> Config:
    """simple/train.py defaults (Config, simple/train.py:27-75): CE +
    label smoothing, stronger jitter, 30 epochs, RAW celeba_spoof root
    (the simple flavor trains without the augmented store),
    ./checkpoints save dir."""
    return Config(
        data=DataConfig(data_root="./celeba_spoof"),
        loss=LossConfig(loss_type="ce", label_smoothing=0.1),
        optim=OptimConfig(num_epochs=30),
        checkpoint=CheckpointConfig(save_dir="./checkpoints"),
        train_aug=TrainAugConfig(
            color_jitter=(0.3, 0.3, 0.3, 0.1), rotation_deg=15.0
        ),
    )


def _test() -> Config:
    """test.py defaults (TestConfig, test.py:44-67)."""
    return Config(
        eval=EvalConfig(
            output_dir="./test_results",
            checkpoint_path="checkpoints_advanced/best_model_run_eif1jakb.pth",
        )
    )


def _augment() -> Config:
    """augment_data.py defaults (AugmentConfig, augment_data.py:27-47)."""
    return Config(augment=AugmentConfig())


def _evaluate_all() -> Config:
    """Cross-model harness defaults (evaluate_all_models.py)."""
    return Config(eval=EvalConfig(output_dir="./results", batch_size=32))


PRESETS = {
    "advanced-train": _advanced_train,
    "simple-train": _simple_train,
    "test": _test,
    "augment": _augment,
    "evaluate-all": _evaluate_all,
}
