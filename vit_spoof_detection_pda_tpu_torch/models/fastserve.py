"""bf16 serving path: uint8 faces in, P(live) out, with each encoder layer
running the two hand-written kernels (counterpart of the JAX package's
``models/fastserve.py``, its ``fastserve`` mode).

Composition (the math of ``models/vit.py`` at serving dtypes):
  x <- pad(embed_patches(batch))        # once, 197 -> 200 rows
  per layer:
    x <- fused_attention_block_padded(x)  # csrc/attention_block.cu
    x <- fused_mlp_block(x)               # csrc/mlp_block.cu
  scores <- head(LN(x[:, :1]))          # CLS row only

The stem and the head are plain PyTorch, as they were plain XLA in the
JAX package: their products are f32 matmuls of bf16-rounded operands
(TF32 off), so they round where JAX's ``preferred_element_type=float32``
dots do.  Parameters use the JAX tree layout (``{"vit": {"block0": ...},
"head": ...}``, ``[in, out]`` kernels); :func:`serving_program` casts
them once to the dtypes the kernels take, on the device.

The B = 1 and B = 2-16 regimes of the JAX package (``lowlat``,
``batch_grid``) are not ported yet: asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_f32_matmul, resolve_device
from ..ops.attention import (_round_up, fused_attention_block_padded,
                             fused_mlp_block)
from ..ops.gelu import gelu
from .vit import patchify

_LOWLAT_TODO = ("the lowlat and batch_grid serving regimes (B <= 16) are "
                "not ported yet: ROADMAP Queue 2 items 7-8")


def _t(leaf, dtype, device) -> torch.Tensor:
    """A parameter leaf as a tensor of ``dtype`` on ``device`` (no copy
    when it already is one; arrays are copied, as they may be read-only)."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.tensor(np.asarray(leaf))
    return leaf.to(device=device, dtype=dtype)


def embed_patches(vit, batch: torch.Tensor, *, dtype,
                  patch_size: int) -> torch.Tensor:
    """ViT stem: patchify-as-GEMM + cls token + pos embed -> ``[B, T, D]``
    in ``dtype``.  The GEMM is an f32 product of the ``dtype``-rounded
    operands plus the f32 bias, rounded once."""
    dev = batch.device
    b = batch.shape[0]
    x = patchify(batch, patch_size=patch_size, dtype=dtype)
    pe = vit["patch_embed"]
    with exact_f32_matmul():
        x = (torch.matmul(x.float(), _t(pe["kernel"], dtype, dev).float())
             + _t(pe["bias"], torch.float32, dev)).to(dtype)
    cls = _t(vit["cls_token"], dtype, dev).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    return x + _t(vit["pos_embed"], dtype, dev)


def _layernorm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """LayerNorm in f32, rounded back to ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    xn = (x32 - mu) * torch.rsqrt(var + eps)
    return (xn * _t(p["scale"], torch.float32, x.device)
            + _t(p["bias"], torch.float32, x.device)).to(x.dtype)


def _as_batch(batch, device) -> torch.Tensor:
    if not isinstance(batch, torch.Tensor):
        batch = torch.tensor(np.asarray(batch))
    return batch.to(device)


@torch.inference_mode()
def serving_forward(params, batch, *, num_heads: int = 12,
                    patch_size: int = 16, depth: int = 12,
                    norm_eps: float = 1e-6, dtype=torch.bfloat16,
                    device=None) -> torch.Tensor:
    """uint8 (or raw [0, 255] float) ``[B, H, W, 3]`` -> P(live) ``[B]``
    f32 on ``device``.

    ``params``: a ViTAntiSpoof tree in the JAX layout, after
    :func:`..models.vit.fold_normalization` so raw uint8 input is right.
    ``device=None`` runs on the card (the kernels); ``device="cpu"`` runs
    the plain versions.  Matches the module forward with tanh GELU in the
    encoder within bf16 resolution."""
    device = resolve_device(device)
    batch = _as_batch(batch, device)
    x = _encode_stream(params["vit"], batch, num_heads=num_heads,
                       patch_size=patch_size, depth=depth,
                       norm_eps=norm_eps, dtype=dtype)
    return _cls_head_scores(params, x, norm_eps=norm_eps, dtype=dtype)


def _encode_stream(vit, batch, *, num_heads: int, patch_size: int,
                   depth: int, norm_eps: float, dtype) -> torch.Tensor:
    """Image batch -> ``[B, Tp, D]`` residual stream after the last block
    (padded to a multiple of 8 rows, before the final LN)."""
    x = embed_patches(vit, batch, dtype=dtype, patch_size=patch_size)
    # the stream is padded once (197 -> 200) and stays padded: pad rows
    # are computed like real rows, their keys masked at valid_len
    t = x.shape[1]
    x = F.pad(x, (0, 0, 0, _round_up(t, 8) - t))
    dev, f32 = batch.device, torch.float32
    for i in range(depth):
        blk = vit[f"block{i}"]
        attn, mlp = blk["attn"], blk["mlp"]
        x = fused_attention_block_padded(
            x, _t(blk["norm1"]["scale"], f32, dev),
            _t(blk["norm1"]["bias"], f32, dev),
            _t(attn["qkv"]["kernel"], dtype, dev),
            _t(attn["qkv"]["bias"], f32, dev),
            _t(attn["proj"]["kernel"], dtype, dev),
            _t(attn["proj"]["bias"], f32, dev),
            num_heads, valid_len=t, eps=norm_eps)
        x = fused_mlp_block(
            x, _t(blk["norm2"]["scale"], f32, dev),
            _t(blk["norm2"]["bias"], f32, dev),
            _t(mlp["fc1"]["kernel"], dtype, dev),
            _t(mlp["fc1"]["bias"], f32, dev),
            _t(mlp["fc2"]["kernel"], dtype, dev),
            _t(mlp["fc2"]["bias"], f32, dev), eps=norm_eps)
    return x


def _cls_head_scores(params, x, *, norm_eps: float, dtype) -> torch.Tensor:
    """Final LN on the CLS row + anti-spoof head -> P(live) ``[B]``.

    The head's fc1 is an f32 product of the f32 features and the
    ``dtype``-rounded kernel (JAX promotes f32 x bf16 to f32); its erf
    GELU output is rounded to ``dtype`` before fc2."""
    dev, f32 = x.device, torch.float32
    x = _layernorm(x[:, :1], params["vit"]["norm"], norm_eps)[:, 0]
    head = params["head"]
    f = _layernorm(x.float(), head["norm"], 1e-5)
    with exact_f32_matmul():
        f = (torch.matmul(f, _t(head["fc1"]["kernel"], dtype, dev).float())
             + _t(head["fc1"]["bias"], f32, dev))
        f = gelu(f, approximate=False)
        logits = (torch.matmul(f.to(dtype).float(),
                               _t(head["fc2"]["kernel"], dtype, dev).float())
                  + _t(head["fc2"]["bias"], f32, dev))
    return torch.sigmoid(logits[:, 1] - logits[:, 0])


# which leaves the serving path reads in the compute dtype; the rest
# (LN scales and biases, linear biases) stay f32
_COMPUTE_DTYPE_LEAVES = ("kernel", "cls_token", "pos_embed")


def prepare_params(params, *, dtype, device):
    """Cast a JAX-layout tree once into the tensors the serving path
    reads: kernels, cls token and pos embed in ``dtype``, LN and bias
    vectors in f32, all contiguous on ``device`` (serving_forward's own
    casts are then no-ops)."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        want = dtype if key in _COMPUTE_DTYPE_LEAVES else torch.float32
        return _t(node, want, device).contiguous()
    return walk(params, None)


def serving_program(model, *, mode: str, dtype=torch.bfloat16, device=None):
    """Resolve a serving regime to ``(weights, raw_fn, kwargs)``: read the
    module's weights into the JAX layout, fold the normalization into
    the patch-embed GEMM and cast once for the kernels."""
    from .convert import antispoof_from_torch
    from .vit import ViTAntiSpoof, fold_normalization

    if not isinstance(model, ViTAntiSpoof):
        raise TypeError("serving programs run the anti-spoof head; got "
                        f"{type(model).__name__}")
    if mode in ("lowlat", "batch_grid"):
        raise NotImplementedError(f"mode={mode!r}: {_LOWLAT_TODO}")
    if mode != "fastserve":
        raise ValueError(f"unknown serving mode {mode!r}")
    device = resolve_device(device)
    variables = antispoof_from_torch(model.state_dict())
    folded = fold_normalization(variables)["params"]
    weights = prepare_params(folded, dtype=dtype, device=device)
    return weights, serving_forward, dict(
        num_heads=model.num_heads, patch_size=model.patch_size,
        depth=model.depth, norm_eps=model.norm_eps, dtype=dtype,
        device=device)


def auto_serving_mode(batch_size: int) -> str:
    """The JAX package's regime table: B = 1 ``lowlat``, 2..16
    ``batch_grid``, >= 17 ``fastserve``.  Only ``fastserve`` is ported."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if batch_size == 1:
        return "lowlat"
    return "batch_grid" if batch_size <= 16 else "fastserve"


def make_serving_fn(model, *, batch_size: int, mode: str = "auto",
                    dtype=torch.bfloat16, device=None):
    """Serving factory: fold normalization, cast the weights once, and
    return ``uint8 [B, H, W, 3] -> P(live) [B]`` (an f32 tensor on the
    device) on the regime for ``batch_size``.

    ``model``: the port's ``ViTAntiSpoof`` holding its unfolded weights.
    Runs on the card unless ``device="cpu"``, and raises when no card is
    present and the CPU was not asked for.  The ``lowlat`` and
    ``batch_grid`` regimes (``mode="auto"`` at B <= 16) raise
    ``NotImplementedError``."""
    device = resolve_device(device)
    if mode == "auto":
        mode = auto_serving_mode(batch_size)
    weights, raw, kw = serving_program(model, mode=mode, dtype=dtype,
                                       device=device)
    return lambda batch_u8: raw(weights, batch_u8, **kw)
