"""Declarative model registry (counterpart of the JAX package's
``models/registry.py``): the four entries the cross-model harness
evaluates, each a builder, a weight source and a converter into the
port module's key set.

:func:`build_model` returns the module with its weights loaded, in eval
mode, on the card unless ``device="cpu"``.  Weights come from a ``.pth``
(``torch.load(weights_only=True)``, numpy values in its ``metrics``
allowed), a ``.safetensors`` file (where the ``safetensors`` package
imports), or a checkpoint directory of the port's Trainer (its last
iterate, or its EMA shadow with ``ema=True``; a JAX Orbax directory where
``orbax`` imports); without a file the
module keeps a random init seeded from ``seed`` (the default generator
reseeded inside ``torch.random.fork_rng``, so the caller's stream is
untouched).  That init does not reproduce flax's bitstream: the tests
carry weights across instead.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional

import torch

from ..device import resolve_device
from . import convert
from .resnet import ResNet50
from .vit import ViTAntiSpoof, ViTLinearHead

log = logging.getLogger(__name__)

@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One registry row (JAX :27).

    ``weights``: "checkpoint" (a ``.pth`` through the converter),
    "pretrained" (a local pretrained file if given) or "random".
    ``placeholder``: the model knowingly stands in for an unavailable one
    (the reference's SigNet_F is an untrained ResNet50, logged)."""

    name: str
    build: Callable[..., torch.nn.Module]   # (dropout, dtype, img_size)
    weights: str = "random"
    weight_converter: Optional[Callable] = None
    placeholder: bool = False
    description: str = ""


def _build_vit_antispoof(dropout=0.1, dtype=torch.float32, img_size=224):
    return ViTAntiSpoof(dropout=dropout, dtype=dtype, img_size=img_size)


def build_vit_from_config(model_cfg, dtype=torch.float32,
                          img_size: int = 224) -> ViTAntiSpoof:
    """A ``ModelConfig`` onto ``ViTAntiSpoof`` (JAX :50): the one mapping
    the train driver and the eval paths share."""
    return ViTAntiSpoof(
        patch_size=model_cfg.patch_size, embed_dim=model_cfg.embed_dim,
        depth=model_cfg.depth, num_heads=model_cfg.num_heads,
        mlp_ratio=model_cfg.mlp_ratio, hidden=model_cfg.head_hidden,
        num_classes=model_cfg.num_classes, dropout=model_cfg.dropout,
        dtype=dtype, gelu=getattr(model_cfg, "gelu", "erf"),
        img_size=img_size)


def _build_vit_linear(dropout=0.1, dtype=torch.float32, img_size=224):
    return ViTLinearHead(dtype=dtype, img_size=img_size)


def _build_resnet50(dropout=0.1, dtype=torch.float32, img_size=224):
    return ResNet50(dtype=dtype)


MODEL_REGISTRY = {
    "Custom_ViT_FineTuned": ModelEntry(
        name="Custom_ViT_FineTuned",
        build=_build_vit_antispoof,
        weights="checkpoint",
        weight_converter=convert.antispoof_from_checkpoint,
        description="ViT-B/16 + MLP head fine-tuned on CelebA-Spoof "
                    "(reference ViTFaceAntiSpoofing, published checkpoint "
                    "best_model_run_eif1jakb.pth)",
    ),
    "Base_ViT_Pretrained": ModelEntry(
        name="Base_ViT_Pretrained",
        build=_build_vit_linear,
        weights="pretrained",
        weight_converter=convert.vit_linear_from_hf,
        description="Frozen ImageNet ViT-B/16 + random 2-way head, no "
                    "fine-tune (ablation; reference "
                    "evaluate_all_models.py:307-318)",
    ),
    "ResNet50_Pretrained": ModelEntry(
        name="ResNet50_Pretrained",
        build=_build_resnet50,
        weights="pretrained",
        weight_converter=convert.resnet50_from_torchvision,
        description="ImageNet ResNet50, fc -> 2 "
                    "(reference evaluate_all_models.py:71-78)",
    ),
    "SigNet_F": ModelEntry(
        name="SigNet_F",
        build=_build_resnet50,
        weights="random",
        placeholder=True,
        description="SigNet-F is not public; untrained ResNet50 stands in "
                    "(reference evaluate_all_models.py:336-355)",
    ),
}


def _seeded_build(entry: ModelEntry, seed: int, **kw) -> torch.nn.Module:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return entry.build(**kw)


def build_model(name: str, *, checkpoint_path: Optional[str] = None,
                pretrained_path: Optional[str] = None, seed: int = 0,
                dtype=torch.float32, dropout: float = 0.1,
                ema: bool = False, img_size: int = 224, device=None):
    """The module of a registry entry (JAX :108), weights loaded, in eval
    mode, on ``device`` (the card unless ``"cpu"``).

    Weight resolution: the checkpoint (or pretrained) path if given and
    present, converted with torch ``load_state_dict(strict=False)``
    semantics when incomplete; tensors whose shapes disagree with the
    module keep its init (``ignore_mismatched_sizes``: a 1000-way
    ImageNet head is not P(live)).  Otherwise a random init from ``seed``
    with a warning (placeholder entries warn that they are untrained).

    A directory is a training run's ``save_dir``: the port's checkpoints
    (``utils/checkpoint.py``), or a JAX Orbax directory where ``orbax``
    imports; its tree must match the module exactly (a mismatch is a
    wrong architecture, never a partial load).  ``ema=True`` loads the
    EMA shadow from such a directory and raises for a file, whose one
    weight set carries no shadow."""
    entry = MODEL_REGISTRY[name]
    device = resolve_device(device)
    module = _seeded_build(entry, seed, dropout=dropout, dtype=dtype,
                           img_size=img_size)
    path = checkpoint_path if entry.weights == "checkpoint" else pretrained_path
    if ema and not (path and os.path.isdir(path)):
        raise ValueError(
            f"{name}: ema=True needs a checkpoint directory (got {path!r}) "
            "— the EMA shadow lives in the optimizer state, which "
            "file-format checkpoints do not carry")
    if path and os.path.isdir(path):
        step = _load_checkpoint_dir(module, path, ema=ema)
        log.info("loaded %s checkpoint step %d from %s%s", name, step, path,
                 " (EMA shadow)" if ema else "")
    elif path and os.path.exists(path) and entry.weight_converter:
        sd = _load_state_dict(path)
        try:
            weights = entry.weight_converter(sd)
        except KeyError:
            # load_state_dict(strict=False), as the reference loads the
            # published checkpoint (evaluate_all_models.py:300)
            weights, missing = convert.convert_partial(
                entry.weight_converter, sd, module)
            log.warning("%s: state dict at %s was incomplete; %d tensors "
                        "kept init values", name, path, len(missing))
        weights, dropped = _drop_mismatched(weights, module)
        if dropped:
            log.warning(
                "%s: %d tensors in %s have mismatched shapes %s — kept "
                "random init for them (reference ignore_mismatched_sizes / "
                "fresh-head semantics)", name, len(dropped), path,
                dropped[:4])
        module.load_state_dict(weights, strict=True)
        log.info("loaded %s weights from %s", name, path)
    elif entry.placeholder:
        log.warning("%s: placeholder model — using UNTRAINED weights "
                    "(expected; see registry description)", name)
    elif path:
        log.warning("%s: weight file %s missing — random init", name, path)
    else:
        log.warning("%s: no %s weights supplied — RANDOM init (pass "
                    "checkpoint_path/pretrained_path to load real weights)",
                    name, entry.weights)
    return module.to(device).eval()


def _drop_mismatched(weights: dict, module: torch.nn.Module):
    """Replace converted tensors whose shape disagrees with the module's
    by the module's own (JAX :246).  Raises when every tensor mismatches
    (a wrong architecture whose key names happen to line up).  Returns
    ``(weights, dropped_keys)``."""
    own = module.state_dict()
    dropped = [k for k, v in weights.items()
               if tuple(v.shape) != tuple(own[k].shape)]
    n_weights = sum(v.is_floating_point() for v in weights.values())
    if dropped and len(dropped) >= n_weights:    # counters are no weights
        raise ValueError(
            f"checkpoint matched the expected key set but ALL "
            f"{n_weights} tensors mismatch the module's shapes — wrong "
            "architecture for this registry entry")
    return {k: own[k] if k in dropped else v
            for k, v in weights.items()}, dropped


def _load_state_dict(path: str) -> dict:
    """A flat state dict from ``path`` (JAX :283): ``.safetensors``
    through the ``safetensors`` package, anything else through
    :func:`convert.load_torch_checkpoint` (``weights_only=True`` with
    numpy's reconstructors allowed), unwrapping the reference's
    ``{"model_state_dict": ...}`` layout."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    return convert.load_torch_checkpoint(path)


def _load_checkpoint_dir(module, path: str, *, ema: bool) -> int:
    """Load a checkpoint directory into ``module`` strictly; returns the
    step."""
    from ..utils.checkpoint import load_checkpoint_bundle

    variables, step, _ = load_checkpoint_bundle(path, ema=ema)
    if isinstance(module, ViTAntiSpoof):
        want = convert.antispoof_from_torch(module.state_dict())
    elif isinstance(module, ViTLinearHead):
        raise NotImplementedError(
            "checkpoint directories hold ViTAntiSpoof trees; the Trainer "
            "trains no other model")
    else:
        raise NotImplementedError(
            f"{type(module).__name__} from a checkpoint directory")
    structure_err, mismatched = geometry_mismatches(want, variables)
    if structure_err or mismatched:
        raise ValueError(
            f"checkpoint {path} does not match the module's parameter tree "
            f"({structure_err or mismatched[:3]}) — wrong architecture for "
            "this entry")
    convert.load_jax_params(module, variables)
    return step


def geometry_mismatches(want, got):
    """Compare two variable trees' geometry (structure and leaf shapes;
    JAX :224).  Returns ``(structure_error, mismatched)``:
    ``structure_error`` is a string when the structures disagree (else
    None), ``mismatched`` lists ``path: got_shape vs want_shape``."""
    want = want.get("params", want) if isinstance(want, dict) else want
    got = got.get("params", got) if isinstance(got, dict) else got
    mismatched = []

    def walk(w, g, path):
        if isinstance(w, dict) or isinstance(g, dict):
            if not (isinstance(w, dict) and isinstance(g, dict)):
                return f"{'/'.join(path)}: a subtree on one side only"
            if set(w) != set(g):
                return (f"{'/'.join(path) or '<root>'}: keys "
                        f"{sorted(set(g) ^ set(w))} differ")
            for k in sorted(w):
                err = walk(w[k], g[k], path + (k,))
                if err:
                    return err
            return None
        if tuple(g.shape) != tuple(w.shape):
            mismatched.append("/".join(path) + f": {tuple(g.shape)} vs "
                              f"{tuple(w.shape)}")
        return None

    return walk(want, got, ()), mismatched
