"""Weights between the JAX-layout parameter tree, upstream checkpoints and
the port's modules (the port's own copy of the JAX package's
``models/convert.py``, numpy and torch only).

JAX tree -> the port's key sets (the tests feed both packages the same
numbers through these):

- :func:`antispoof_to_torch`: ``{"params": {"vit": ..., "head": ...}}``
  (``[in, out]`` kernels) -> the published checkpoint's key set
  (``vit.<timm names>`` + ``classifier.{0,2,5}``).
- :func:`vit_linear_to_torch`: a ``ViTLinearHead`` tree -> ``vit.*`` +
  ``classifier``.
- :func:`resnet50_to_torch`: a ``ResNet50`` tree with its
  ``batch_stats`` -> torchvision's key set.
- :func:`load_jax_params`: any of the three into its port module with
  ``strict=True``.
- :func:`antispoof_from_torch` / :func:`vit_linear_from_torch`: the
  inverses of the first two, used by the serving paths to lay a module's
  weights out for the kernels.
- :func:`antispoof_state_from_tree`: the first as torch ops on tensors,
  differentiable (the module path's training forward over the tree).
- :func:`train_state_arrays`: a JAX ``TrainState``'s params, AdamW
  moments and EMA shadow as numpy, in the order the port's
  ``TrainState`` keeps its leaves (``create_train_state(opt_arrays=)``).

Reference-format ``.pth`` files (SURVEY §2.4: ``model_state_dict``,
``epoch``, ``metrics``, ``config``): :func:`save_torch_checkpoint` and
:func:`load_torch_checkpoint` (``torch.load(weights_only=True)`` with
numpy's scalar, array and dtype reconstructors allowed, since the
reference's metrics are numpy values).

Upstream state dicts -> the port's key sets (the converters
``models/registry.py`` names; each raises ``KeyError`` on a missing
tensor, or marks it :data:`MISSING` with ``tolerant=True``):

- :func:`antispoof_from_checkpoint`: the published fine-tune checkpoint
  (already the port's keys).
- :func:`vit_linear_from_hf`: HF ``ViTForImageClassification``, its
  separate query/key/value fused into ``qkv`` as the JAX converter fuses
  them (:func:`vit_backbone_from_hf`).
- :func:`resnet50_from_torchvision`: torchvision ``resnet50``.
- :func:`convert_partial`: ``load_state_dict(strict=False)`` semantics
  over any of them.
"""

from __future__ import annotations

import logging
from typing import Callable, Mapping

import numpy as np
import torch

log = logging.getLogger(__name__)

# A tensor absent from the source state dict, in tolerant mode
# (torch load_state_dict(strict=False) semantics).
MISSING = None


def _np(x) -> np.ndarray:
    """torch tensor | array -> float32 numpy (detached, contiguous)."""
    if hasattr(x, "detach"):
        # .float() first: numpy() raises on torch bfloat16 tensors
        x = x.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def vit_backbone_to_timm(params, prefix: str = "", patch_size: int = 16,
                         channels: int = 3) -> dict:
    """ViT params -> flat timm-named numpy state dict
    (``{prefix}patch_embed.proj.weight`` etc.)."""
    def lin(p):
        return {"weight": _np(p["kernel"]).T, "bias": _np(p["bias"])}

    def ln(p):
        return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}

    sd = {}
    k = _np(params["patch_embed"]["kernel"])             # [p*p*c, D]
    d = k.shape[1]
    inferred = round((k.shape[0] / channels) ** 0.5)
    if inferred * inferred * channels == k.shape[0]:
        patch_size = inferred        # export any patch size, not just 16
    elif patch_size * patch_size * channels != k.shape[0]:
        raise ValueError(
            f"patch kernel rows {k.shape[0]} match neither the inferred "
            f"square patch nor patch_size={patch_size} x {channels}ch")
    sd[f"{prefix}patch_embed.proj.weight"] = k.reshape(
        patch_size, patch_size, channels, d).transpose(3, 2, 0, 1)
    sd[f"{prefix}patch_embed.proj.bias"] = _np(params["patch_embed"]["bias"])
    sd[f"{prefix}cls_token"] = _np(params["cls_token"])
    sd[f"{prefix}pos_embed"] = _np(params["pos_embed"])
    for key, val in ln(params["norm"]).items():
        sd[f"{prefix}norm.{key}"] = val
    i = 0
    while f"block{i}" in params:
        blk = params[f"block{i}"]
        flat = {
            f"blocks.{i}.norm1": ln(blk["norm1"]),
            f"blocks.{i}.attn.qkv": lin(blk["attn"]["qkv"]),
            f"blocks.{i}.attn.proj": lin(blk["attn"]["proj"]),
            f"blocks.{i}.norm2": ln(blk["norm2"]),
            f"blocks.{i}.mlp.fc1": lin(blk["mlp"]["fc1"]),
            f"blocks.{i}.mlp.fc2": lin(blk["mlp"]["fc2"]),
        }
        for mod, parts in flat.items():
            for key, val in parts.items():
                sd[f"{prefix}{mod}.{key}"] = val
        i += 1
    return sd


def antispoof_to_torch(variables) -> dict:
    """ViTAntiSpoof variables -> the published checkpoint's key set
    (``vit.<timm>`` backbone + head as ``classifier.{0,2,5}``)."""
    params = variables["params"] if "params" in variables else variables
    sd = vit_backbone_to_timm(params["vit"], prefix="vit.")
    head = params["head"]
    sd["classifier.0.weight"] = _np(head["norm"]["scale"])
    sd["classifier.0.bias"] = _np(head["norm"]["bias"])
    sd["classifier.2.weight"] = _np(head["fc1"]["kernel"]).T
    sd["classifier.2.bias"] = _np(head["fc1"]["bias"])
    sd["classifier.5.weight"] = _np(head["fc2"]["kernel"]).T
    sd["classifier.5.bias"] = _np(head["fc2"]["bias"])
    return sd


def _linear(sd: Mapping, name: str) -> dict:
    return {"kernel": _np(sd[f"{name}.weight"]).T,
            "bias": _np(sd[f"{name}.bias"])}


def _layernorm(sd: Mapping, name: str) -> dict:
    return {"scale": _np(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"])}


def vit_backbone_from_timm(sd: Mapping, prefix: str = "") -> dict:
    """timm-named ViT state dict -> JAX-layout ViT params (numpy).  The
    patch conv ``[D, C, p, p]`` flattens to the ``[p*p*C, D]`` patch-GEMM
    kernel in (row, column, channel) order; depth is read off the keys.
    A missing key raises ``KeyError``."""
    p = prefix
    conv_w = _np(sd[f"{p}patch_embed.proj.weight"])
    params = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(
                conv_w.transpose(2, 3, 1, 0).reshape(-1, conv_w.shape[0])),
            "bias": _np(sd[f"{p}patch_embed.proj.bias"])},
        "cls_token": _np(sd[f"{p}cls_token"]),
        "pos_embed": _np(sd[f"{p}pos_embed"]),
        "norm": _layernorm(sd, f"{p}norm"),
    }
    i = 0
    while f"{p}blocks.{i}.norm1.weight" in sd:
        b = f"{p}blocks.{i}"
        params[f"block{i}"] = {
            "norm1": _layernorm(sd, f"{b}.norm1"),
            "attn": {"qkv": _linear(sd, f"{b}.attn.qkv"),
                     "proj": _linear(sd, f"{b}.attn.proj")},
            "norm2": _layernorm(sd, f"{b}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"),
                    "fc2": _linear(sd, f"{b}.mlp.fc2")},
        }
        i += 1
    return params


def antispoof_from_torch(sd: Mapping) -> dict:
    """Published-checkpoint state dict (``vit.*`` + ``classifier.{0,2,5}``)
    -> ``{"params": ...}`` in the JAX layout (numpy)."""
    return {"params": {
        "vit": vit_backbone_from_timm(sd, prefix="vit."),
        "head": {"norm": _layernorm(sd, "classifier.0"),
                 "fc1": _linear(sd, "classifier.2"),
                 "fc2": _linear(sd, "classifier.5")},
    }}


def vit_linear_to_torch(variables) -> dict:
    """ViTLinearHead variables -> ``vit.<timm>`` + ``classifier``."""
    params = variables["params"] if "params" in variables else variables
    sd = vit_backbone_to_timm(params["vit"], prefix="vit.")
    sd["classifier.weight"] = _np(params["classifier"]["kernel"]).T
    sd["classifier.bias"] = _np(params["classifier"]["bias"])
    return sd


def vit_linear_from_torch(sd: Mapping) -> dict:
    """A ``ViTLinearHead`` state dict (``vit.*`` + ``classifier``) ->
    ``{"params": {"vit": ..., "classifier": ...}}`` in the JAX layout
    (numpy); the inverse of :func:`vit_linear_to_torch`."""
    return {"params": {"vit": vit_backbone_from_timm(sd, prefix="vit."),
                       "classifier": _linear(sd, "classifier")}}


def _stage_blocks(params) -> list:
    """``[(JAX block name, torchvision prefix, has projection)]`` of a
    ResNet50 tree, read off its keys."""
    out, stage = [], 1
    while f"layer{stage}_0" in params:
        block = 0
        while f"layer{stage}_{block}" in params:
            name = f"layer{stage}_{block}"
            out.append((name, f"layer{stage}.{block}",
                        "downsample_conv" in params[name]))
            block += 1
        stage += 1
    return out


def resnet50_to_torch(variables) -> dict:
    """ResNet50 variables (``params`` + ``batch_stats``) -> torchvision's
    key set: conv kernels ``[kh, kw, I, O]`` -> ``[O, I, kh, kw]``, the
    BatchNorms' scale, bias and running statistics (``num_batches_tracked``
    0), the fc transposed."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)

    def bn(name, p, st):
        sd[f"{name}.weight"] = _np(p["scale"])
        sd[f"{name}.bias"] = _np(p["bias"])
        sd[f"{name}.running_mean"] = _np(st["mean"])
        sd[f"{name}.running_var"] = _np(st["var"])
        sd[f"{name}.num_batches_tracked"] = np.array(0, np.int64)

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    for name, prefix, project in _stage_blocks(params):
        p, st = params[name], stats[name]
        for j in (1, 2, 3):
            conv(f"{prefix}.conv{j}", p[f"conv{j}"])
            bn(f"{prefix}.bn{j}", p[f"bn{j}"], st[f"bn{j}"])
        if project:
            conv(f"{prefix}.downsample.0", p["downsample_conv"])
            bn(f"{prefix}.downsample.1", p["downsample_bn"],
               st["downsample_bn"])
    sd["fc.weight"] = _np(params["fc"]["kernel"]).T
    sd["fc.bias"] = _np(params["fc"]["bias"])
    return sd


def antispoof_state_from_tree(params, patch_size: int = 16,
                              channels: int = 3) -> dict:
    """:func:`antispoof_to_torch` as torch ops: a JAX-layout ViTAntiSpoof
    tree of tensors (``{"vit": ..., "head": ...}``) -> the module's state
    dict, each entry a view or transpose of its leaf, so gradients flow
    back to the tree (``torch.func.functional_call`` over the module)."""
    vit, head = params["vit"], params["head"]
    k = vit["patch_embed"]["kernel"]                     # [p*p*c, D]
    sd = {"vit.patch_embed.proj.weight": k.reshape(
              patch_size, patch_size, channels, k.shape[1]).permute(3, 2, 0, 1),
          "vit.patch_embed.proj.bias": vit["patch_embed"]["bias"],
          "vit.cls_token": vit["cls_token"], "vit.pos_embed": vit["pos_embed"],
          "vit.norm.weight": vit["norm"]["scale"],
          "vit.norm.bias": vit["norm"]["bias"]}
    i = 0
    while f"block{i}" in vit:
        blk = vit[f"block{i}"]
        for mod, node in ((f"blocks.{i}.norm1", blk["norm1"]),
                          (f"blocks.{i}.norm2", blk["norm2"])):
            sd[f"vit.{mod}.weight"], sd[f"vit.{mod}.bias"] = (
                node["scale"], node["bias"])
        for mod, node in ((f"blocks.{i}.attn.qkv", blk["attn"]["qkv"]),
                          (f"blocks.{i}.attn.proj", blk["attn"]["proj"]),
                          (f"blocks.{i}.mlp.fc1", blk["mlp"]["fc1"]),
                          (f"blocks.{i}.mlp.fc2", blk["mlp"]["fc2"])):
            sd[f"vit.{mod}.weight"] = node["kernel"].t()
            sd[f"vit.{mod}.bias"] = node["bias"]
        i += 1
    sd["classifier.0.weight"] = head["norm"]["scale"]
    sd["classifier.0.bias"] = head["norm"]["bias"]
    for idx, name in ((2, "fc1"), (5, "fc2")):
        sd[f"classifier.{idx}.weight"] = head[name]["kernel"].t()
        sd[f"classifier.{idx}.bias"] = head[name]["bias"]
    return sd


def train_state_arrays(jax_state) -> dict:
    """A JAX ``TrainState`` as numpy, laid out for the port's
    ``TrainState``: ``{"params": tree, "step": int, "count": int, "mu":
    [...], "nu": [...], "ema": [...] | None}``, the moment and EMA lists
    in the port's leaf order (the tree's sorted keys, JAX's order for
    dicts).  Reads the optax chain's state by its node types (AdamW's
    ``mu``/``nu``/``count``, the EMA's ``polyak_shadow``) without
    importing optax; ``gradient_accumulation_steps > 1`` is refused.
    Feed it to ``train.state.create_train_state(opt_arrays=...)``."""
    from ..train.state import tree_flatten

    found = {}

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu") and hasattr(
                node, "count"):
            found["adam"] = node
        elif hasattr(node, "polyak_shadow"):
            found["ema"] = node.polyak_shadow
        elif hasattr(node, "mini_step"):
            raise ValueError("a JAX state under gradient accumulation "
                             "(optax.MultiSteps) is not carried across")
        if isinstance(node, dict):
            children = node.values()
        elif isinstance(node, (list, tuple)):
            children = node
        else:
            return
        for child in children:
            walk(child)

    walk(jax_state.opt_state)
    if "adam" not in found:
        raise ValueError("no AdamW state (mu, nu, count) in the JAX "
                         "opt_state")
    adam = found["adam"]

    def leaves(tree):
        return tree_flatten(_as_dict(tree))[0]

    return {"params": _as_dict(jax_state.params),
            "step": int(np.asarray(jax_state.step)),
            "count": int(np.asarray(adam.count)),
            "mu": leaves(adam.mu), "nu": leaves(adam.nu),
            "ema": leaves(found["ema"]) if "ema" in found else None}


def _as_dict(tree):
    """A nested mapping (flax ``FrozenDict`` included) as plain dicts of
    numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _as_dict(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def load_jax_params(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a JAX-layout tree into its port module with ``strict=True``:
    ``ViTAntiSpoof`` and ``ViTLinearHead`` take ``{"params": ...}`` or
    the bare params, ``ResNet50`` the variables with ``batch_stats``.
    Returns the module."""
    from .resnet import ResNet50
    from .vit import ViTLinearHead

    if isinstance(module, ResNet50):
        sd = resnet50_to_torch(variables)
    elif isinstance(module, ViTLinearHead):
        sd = vit_linear_to_torch(variables)
    else:
        sd = antispoof_to_torch(variables)
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module


# --------------------------------------------------------------------------
# Upstream state dicts -> the port's key sets
# --------------------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    """A state-dict leaf as a CPU tensor: floats as f32, integers kept."""
    t = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))
    return t.float() if t.is_floating_point() else t


def _leaf(sd: Mapping, key: str, tolerant: bool):
    if key in sd:
        return _tensor(sd[key])
    if tolerant:
        return MISSING
    raise KeyError(key)


def _take(sd: Mapping, names, tolerant: bool, src_prefix: str = "",
          dst_prefix: str = "") -> dict:
    return {dst_prefix + n: _leaf(sd, src_prefix + n, tolerant)
            for n in names}


def _timm_backbone_names(depth: int) -> list:
    names = ["patch_embed.proj.weight", "patch_embed.proj.bias",
             "cls_token", "pos_embed", "norm.weight", "norm.bias"]
    for i in range(depth):
        for mod in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                    "mlp.fc2"):
            names += [f"blocks.{i}.{mod}.weight", f"blocks.{i}.{mod}.bias"]
    return names


def antispoof_from_checkpoint(sd: Mapping, depth: int = 12, *,
                              tolerant: bool = False) -> dict:
    """The published fine-tune checkpoint (``vit.<timm>`` +
    ``classifier.{0,2,5}``; JAX ``antispoof_from_torch`` :251) -> the
    port's ``ViTAntiSpoof`` state dict; extra keys are ignored."""
    out = _take(sd, _timm_backbone_names(depth), tolerant, "vit.", "vit.")
    out.update(_take(sd, [f"classifier.{i}.{w}" for i in (0, 2, 5)
                          for w in ("weight", "bias")], tolerant))
    return out


def vit_backbone_from_hf(sd: Mapping, prefix: str = "", depth: int = 12, *,
                         tolerant: bool = False) -> dict:
    """HF ``ViTModel`` state dict -> timm-named backbone tensors (JAX
    :196).  HF's separate query/key/value Linears fuse into ``qkv`` by
    concatenation along the output dim; the fused weight and bias fall
    back to the module's init together when any of the six parts is
    absent (a loaded q beside a random k would be inconsistent)."""
    p = prefix
    out = {
        "patch_embed.proj.weight": _leaf(
            sd, f"{p}embeddings.patch_embeddings.projection.weight", tolerant),
        "patch_embed.proj.bias": _leaf(
            sd, f"{p}embeddings.patch_embeddings.projection.bias", tolerant),
        "cls_token": _leaf(sd, f"{p}embeddings.cls_token", tolerant),
        "pos_embed": _leaf(sd, f"{p}embeddings.position_embeddings",
                           tolerant),
        "norm.weight": _leaf(sd, f"{p}layernorm.weight", tolerant),
        "norm.bias": _leaf(sd, f"{p}layernorm.bias", tolerant),
    }
    renames = {"norm1": "layernorm_before",
               "attn.proj": "attention.output.dense",
               "norm2": "layernorm_after", "mlp.fc1": "intermediate.dense",
               "mlp.fc2": "output.dense"}
    for i in range(depth):
        b, t = f"{p}encoder.layer.{i}", f"blocks.{i}"
        for mine, theirs in renames.items():
            for w in ("weight", "bias"):
                out[f"{t}.{mine}.{w}"] = _leaf(sd, f"{b}.{theirs}.{w}",
                                               tolerant)
        for w in ("weight", "bias"):
            parts = [_leaf(sd, f"{b}.attention.attention.{x}.{w}", tolerant)
                     for x in ("query", "key", "value")]
            out[f"{t}.attn.qkv.{w}"] = (
                MISSING if any(x is MISSING for x in parts)
                else torch.cat(parts, dim=0))
        if (out[f"{t}.attn.qkv.weight"] is MISSING
                or out[f"{t}.attn.qkv.bias"] is MISSING):
            out[f"{t}.attn.qkv.weight"] = out[f"{t}.attn.qkv.bias"] = MISSING
    return out


def vit_linear_from_hf(sd: Mapping, depth: int = 12, *,
                       tolerant: bool = False) -> dict:
    """HF ``ViTForImageClassification`` -> the port's ``ViTLinearHead``
    state dict (``vit.*`` + ``classifier``; JAX :270)."""
    out = {f"vit.{k}": v for k, v in vit_backbone_from_hf(
        sd, "vit.", depth, tolerant=tolerant).items()}
    out.update(_take(sd, ["classifier.weight", "classifier.bias"], tolerant))
    return out


def resnet50_from_torchvision(sd: Mapping, stage_sizes=(3, 4, 6, 3), *,
                              tolerant: bool = False) -> dict:
    """torchvision ``resnet50`` state dict -> the port's ``ResNet50``
    state dict (the same keys; JAX :280).  A missing
    ``num_batches_tracked`` (not a weight) is 0."""
    bn = ("weight", "bias", "running_mean", "running_var")
    names = ["conv1.weight", "fc.weight", "fc.bias"] + [f"bn1.{w}"
                                                        for w in bn]
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            t = f"layer{stage + 1}.{block}"
            for j in (1, 2, 3):
                names += [f"{t}.conv{j}.weight"] + [f"{t}.bn{j}.{w}"
                                                    for w in bn]
            if block == 0:
                names += [f"{t}.downsample.0.weight"] + [
                    f"{t}.downsample.1.{w}" for w in bn]
    out = _take(sd, names, tolerant)
    for n in names:
        if n.endswith("running_var"):
            key = n[:-len("running_var")] + "num_batches_tracked"
            out[key] = _tensor(sd[key]) if key in sd else torch.tensor(0)
    return out


def convert_partial(converter: Callable, sd: Mapping,
                    module: torch.nn.Module, **kwargs):
    """Run ``converter`` with ``load_state_dict(strict=False)`` semantics
    (JAX :94): tensors present in ``sd`` are converted, the rest keep the
    module's own values, unexpected keys are ignored.  Raises
    ``KeyError`` when nothing matched (the wrong checkpoint format, not a
    partial load).  Returns ``(state_dict, missing_keys)``; the missing
    keys are logged."""
    converted = converter(sd, tolerant=True, **kwargs)
    if converted and all(v is MISSING for v in converted.values()):
        raise KeyError(
            f"state dict matched none of the {len(converted)} expected "
            "tensors — wrong checkpoint format for this converter")
    own = module.state_dict()
    missing = [k for k, v in converted.items() if v is MISSING]
    merged = {k: own[k] if v is MISSING else v for k, v in converted.items()}
    if missing:
        log.warning("partial weight load: %d/%d tensors missing from state "
                    "dict kept their init values: %s", len(missing),
                    len(converted), ", ".join(missing[:8])
                    + ("..." if len(missing) > 8 else ""))
    return merged, missing


# --------------------------------------------------------------------------
# Reference-format checkpoint files
# --------------------------------------------------------------------------


def _numpy_safe_globals() -> list:
    """numpy's scalar, array and dtype reconstructors for
    ``torch.serialization.safe_globals``, under the names numpy 1.x
    (``numpy.core``) and 2.x (``numpy._core``) pickle them with."""
    try:
        from numpy._core import multiarray as ma
    except ImportError:                              # numpy < 2
        from numpy.core import multiarray as ma
    out = [np.ndarray, np.dtype]
    for fn in (ma.scalar, ma._reconstruct):
        out += [(fn, f"numpy.core.multiarray.{fn.__name__}"),
                (fn, f"numpy._core.multiarray.{fn.__name__}")]
    dtypes = getattr(np, "dtypes", None)             # numpy >= 1.25
    if dtypes is not None:
        out += [getattr(dtypes, n) for n in dir(dtypes) if n.endswith("DType")]
    return out


def load_torch_checkpoint(path: str) -> dict:
    """A torch ``.pth`` -> its flat state dict: the reference's checkpoint
    dict (``model_state_dict`` + ``epoch`` + ``metrics`` + ``config``,
    train_advanced.py:475-489) or a bare state dict.

    ``torch.load(weights_only=True)``, with numpy's scalar, array and
    dtype reconstructors allowed (the reference's validation metrics are
    numpy values next to the state dicts); every other class is still
    refused.  The JAX package loads with ``weights_only=False``, as
    test.py:174 does."""
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        return obj["model_state_dict"]
    return obj


def save_torch_checkpoint(path: str, variables, *, epoch: int = 0,
                          metrics: dict | None = None,
                          config: dict | None = None) -> dict:
    """Write a reference-format ``.pth`` (the dict layout of
    train_advanced.py:475-489: epoch + model_state_dict + metrics +
    config) of a ViTAntiSpoof tree, loadable by the reference's
    ``load_checkpoint`` (test.py:167-188) and by
    :func:`load_torch_checkpoint`.  Returns the exported state dict."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v.astype(np.float32)))
          for k, v in antispoof_to_torch(variables).items()}
    torch.save({"epoch": epoch, "model_state_dict": sd,
                "metrics": metrics or {}, "config": config or {}}, path)
    return sd
