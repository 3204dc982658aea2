"""bf16 serving path: uint8 faces in, P(live) out (counterpart of the JAX
package's ``models/fastserve.py``), in its three regimes
(:func:`auto_serving_mode` picks one by batch size, from the H100's
measured table):

- ``fastserve`` (B >= 3): each encoder layer on the two hand-written
  kernels, composed as below.
- ``lowlat`` (B = 1): the whole forward, patch rows to logits, in one
  launch of ``csrc/lowlat_encoder.cu`` (:func:`serving_forward_lowlat`,
  packs from :func:`prepare_lowlat`).
- ``batch_grid`` (B = 2; B = 2-16 on the TPU, and on the card any B by
  ``mode=``): the whole encoder in one launch of
  ``csrc/lowlat_batchgrid.cu`` per chunk of up to 4 items
  (:func:`serving_forward_lowlat_batch`).

Composition (the math of ``models/vit.py`` at serving dtypes):
  x <- pad(embed_patches(batch))        # once, 197 -> 200 rows
  per layer:
    x <- fused_attention_block_padded(x)  # csrc/attention_block.cu
    x <- fused_mlp_block(x)               # csrc/mlp_block.cu
  scores <- head(LN(x[:, :1]))          # CLS row only

``fuse_mlp=False`` runs each MLP half-layer as the row-local LayerNorm,
then fc1 and fc2 on the GEMM core alone (``ops/gemm.py::gemm``, kernel
2's own ``"bias_gelu"`` and ``"bias_residual"`` epilogues).  Two heads
share the trunk: the anti-spoof head (P(live) ``[B]``) and the linear
head of ``ViTLinearHead`` (softmax ``[B, C]``,
:func:`serving_forward_linear`, :func:`serving_forward_lowlat_linear`).
:func:`serving_forward_sharded` runs either over a mesh's data axis, one
process per rank.

The stem and the head are plain PyTorch, as they were plain XLA in the
JAX package: their products are f32 matmuls of bf16-rounded operands
(TF32 off), so they round where JAX's ``preferred_element_type=float32``
dots do.  Parameters use the JAX tree layout (``{"vit": {"block0": ...},
"head": ...}``, ``[in, out]`` kernels); :func:`serving_program` casts
them once to the dtypes the kernels take, on the device.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_f32_matmul, resolve_device
from ..ops.attention import (_round_up, fused_attention_block_padded,
                             fused_mlp_block)
from ..ops.gelu import gelu
from ..ops.gemm import gemm
from ..utils.profiling import annotate
from .vit import patchify

log = logging.getLogger(__name__)


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


def padded_stream(vit, batch: torch.Tensor, *, dtype, patch_size: int):
    """The stem's ``[B, T, D]`` output zero-padded to ``Tp``, a multiple
    of 8 rows (197 -> 200 at ViT-B/16): ``(stream, T)``, in the span
    ``vsd.serve.stem``."""
    with annotate("vsd.serve.stem"):
        x = embed_patches(vit, batch, dtype=dtype, patch_size=patch_size)
        t = x.shape[1]
        return F.pad(x, (0, 0, 0, _round_up(t, 8) - t)).contiguous(), t


def patch_rows(batch: torch.Tensor, *, patch_size: int, tp: int, dtype):
    """The fold-ends kernel's input: ``[B, Tp, p*p*3]`` patch rows with
    row 0 zero (the CLS slot; the kernel's aux carries cls + pos 0) and
    zero rows after the last patch."""
    x = patchify(batch, patch_size=patch_size, dtype=dtype)
    return F.pad(x, (0, 0, 1, tp - 1 - x.shape[1])).contiguous()


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
                    fuse_mlp: bool = True, device=None) -> torch.Tensor:
    """uint8 (or raw [0, 255] float) ``[B, H, W, 3]`` -> P(live) ``[B]``
    f32 on ``device``.

    ``params``: a ViTAntiSpoof tree in the JAX layout, after
    :func:`..models.vit.fold_normalization` so raw uint8 input is right.
    ``device=None`` runs on the card (the kernels); ``device="cpu"`` runs
    the plain versions.  Matches the module forward with tanh GELU in the
    encoder within bf16 resolution.  ``fuse_mlp=False``: the MLP on the
    GEMM core (:func:`_mlp_unfused`) instead of kernel 2."""
    device = resolve_device(device)
    batch = _as_batch(batch, device)
    x = _encode_stream(params["vit"], batch, num_heads=num_heads,
                       patch_size=patch_size, depth=depth,
                       norm_eps=norm_eps, dtype=dtype, fuse_mlp=fuse_mlp)
    return _cls_head_scores(params, x, norm_eps=norm_eps, dtype=dtype)


@torch.inference_mode()
def serving_forward_linear(params, batch, *, num_heads: int = 12,
                           patch_size: int = 16, depth: int = 12,
                           norm_eps: float = 1e-12, dtype=torch.bfloat16,
                           fuse_mlp: bool = True,
                           device=None) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> softmax probabilities ``[B, C]`` f32 of
    the linear-head ViT (``models/vit.py::ViTLinearHead``, the frozen
    "Base ViT" ablation): the trunk of :func:`serving_forward`, then the
    final LayerNorm on the CLS row (HF eps 1e-12) and the f32 classifier.
    ``params``: its JAX-layout tree (``{"vit", "classifier"}``) after
    ``fold_normalization``."""
    device = resolve_device(device)
    batch = _as_batch(batch, device)
    x = _encode_stream(params["vit"], batch, num_heads=num_heads,
                       patch_size=patch_size, depth=depth,
                       norm_eps=norm_eps, dtype=dtype, fuse_mlp=fuse_mlp)
    return _linear_head_probs(params, x, norm_eps=norm_eps)


@torch.inference_mode()
def serving_forward_sharded(params, batch, mesh, *, fn=serving_forward,
                            **kwargs) -> torch.Tensor:
    """Data-parallel scoring over ``mesh``'s data axis (JAX :379), one
    process per rank: each data rank runs ``fn`` (:func:`serving_forward`
    by default, or :func:`serving_forward_linear`) with the replicated
    ``params`` on its contiguous block of the global ``batch`` (the block
    ``parallel/mesh.py::shard_batch`` gives, JAX's ``P("data")``); the
    ranks of one group along the other axes score the same block, as
    JAX's ``shard_map`` replicates over them.  The scores are gathered
    over the data group in batch order, so every rank returns the global
    batch's.  On the card each rank's forward runs kernels 1 and 2 once
    a layer; on the CPU their plain versions."""
    from ..parallel.collectives import gather_rows
    from ..parallel.mesh import DATA_AXIS, axis_sizes, shard_batch

    ndata = axis_sizes(mesh).get(DATA_AXIS, 1)
    if batch.shape[0] % ndata:
        raise ValueError(
            f"batch {batch.shape[0]} not divisible by data axis {ndata}")
    block = shard_batch({"batch": batch}, mesh)["batch"]
    out = fn(params, block, **kwargs)
    return gather_rows(out, mesh.get_group(DATA_AXIS))


def _mlp_unfused(x, norm, mlp, *, eps: float, dtype) -> torch.Tensor:
    """One MLP half-layer off kernel 2 (``fuse_mlp=False``): the
    row-local LayerNorm, then fc1 with the tanh GELU and fc2 with the
    residual on the GEMM core (``ops/gemm.py::gemm``; its plain version on
    the CPU).  The core rounds each output once, after its epilogue: the
    JAX package rounds ``acc + b`` to ``dtype`` before its GELU and fc2's
    output before the residual add, so at bf16 the two differ by those
    roundings (within the bf16 score tolerance of the tests)."""
    dev, f32 = x.device, torch.float32
    b, tp, d = x.shape
    rows = x.reshape(b * tp, d)
    y = _layernorm(rows, norm, eps)
    h = gemm(y, _t(mlp["fc1"]["kernel"], dtype, dev),
             _t(mlp["fc1"]["bias"], f32, dev), epilogue="bias_gelu")
    out = gemm(h, _t(mlp["fc2"]["kernel"], dtype, dev),
               _t(mlp["fc2"]["bias"], f32, dev), epilogue="bias_residual",
               residual=rows)
    return out.view(b, tp, d)


def _encode_stream(vit, batch, *, num_heads: int, patch_size: int,
                   depth: int, norm_eps: float, dtype,
                   fuse_mlp: bool = True) -> torch.Tensor:
    """Image batch -> ``[B, Tp, D]`` residual stream after the last block
    (padded to a multiple of 8 rows, before the final LN)."""
    # the stream is padded once (197 -> 200) and stays padded: pad rows
    # are computed like real rows, their keys masked at valid_len
    x, t = padded_stream(vit, batch, dtype=dtype, patch_size=patch_size)
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
        if not fuse_mlp:
            x = _mlp_unfused(x, blk["norm2"], mlp, eps=norm_eps, dtype=dtype)
            continue
        x = fused_mlp_block(
            x, _t(blk["norm2"]["scale"], f32, dev),
            _t(blk["norm2"]["bias"], f32, dev),
            _t(mlp["fc1"]["kernel"], dtype, dev),
            _t(mlp["fc1"]["bias"], f32, dev),
            _t(mlp["fc2"]["kernel"], dtype, dev),
            _t(mlp["fc2"]["bias"], f32, dev), eps=norm_eps)
    return x


def _linear_head_probs(params, x, *, norm_eps: float) -> torch.Tensor:
    """Final LN on the CLS row + the f32 classifier -> softmax ``[B, C]``:
    an f32 product of the ``dtype``-rounded features and the f32 kernel
    (TF32 off), as JAX's ``preferred_element_type=float32`` dot."""
    dev, f32 = x.device, torch.float32
    feats = _layernorm(x[:, :1], params["vit"]["norm"], norm_eps)[:, 0]
    cls = params["classifier"]
    with exact_f32_matmul():
        logits = (torch.matmul(feats.float(), _t(cls["kernel"], f32, dev))
                  + _t(cls["bias"], f32, dev))
    return torch.softmax(logits, dim=-1)


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
# (LN scales and biases, linear biases) stay f32, and so does the whole
# linear head's classifier (an f32 Dense, as in the JAX package)
_COMPUTE_DTYPE_LEAVES = ("kernel", "cls_token", "pos_embed")
_F32_SUBTREES = ("classifier",)


def prepare_params(params, *, dtype, device):
    """Cast a JAX-layout tree once into the tensors the serving path
    reads: kernels, cls token and pos embed in ``dtype``, LN and bias
    vectors and the linear head's ``classifier`` in f32, all contiguous on
    ``device`` (the forwards' own casts are then no-ops)."""
    def walk(node, key, dt):
        if isinstance(node, dict):
            dt = torch.float32 if key in _F32_SUBTREES else dt
            return {k: walk(v, k, dt) for k, v in node.items()}
        want = dt if key in _COMPUTE_DTYPE_LEAVES else torch.float32
        return _t(node, want, device).contiguous()
    return walk(params, None, dtype)


def prepare_lowlat(params, *, depth: int = 12, dtype=torch.bfloat16,
                   fold_ends: bool = True, batch_grid: bool = False,
                   per_item: bool = True, int8_weights: bool = False,
                   device=None):
    """Pack a folded JAX-layout tree for the whole-encoder kernels, once:
    ``{"params": the tree cast as prepare_params casts it, "packed_w",
    "packed_s"}`` for the per-item kernel, plus ``"end_w"``, ``"end_s"``,
    ``"aux"`` with ``fold_ends`` (the stem and head folded in; shapes
    that cannot ride that layout, patch_dim != embed_dim, fall back to the
    encoder-only kernel with a warning, as in the JAX package), plus
    ``"bg_w"``, ``"bg_s"`` with ``batch_grid``.  ``per_item=False`` skips
    the per-item and fold-ends packs.  ``int8_weights`` packs the per-item
    encoder stream weight-only int8 (``ops/lowlat.py``
    ``pack_encoder_weights(weight_dtype=torch.int8)``: half the weight
    bytes; the stem/head block and the activations stay ``dtype``).
    Packs go to ``device`` (the card unless ``device="cpu"``)."""
    from ..ops.lowlat import (pack_encoder_weights,
                              pack_encoder_weights_batchgrid,
                              pack_end_weights)

    if not (per_item or batch_grid):
        raise ValueError("prepare_lowlat with per_item=False needs "
                         "batch_grid=True — nothing would be packed")
    if int8_weights and not per_item:
        raise ValueError("int8_weights quantizes the per-item stream; "
                         "the batch-grid pack stays full-precision "
                         "(weights already amortize per chunk there)")
    device = resolve_device(device)
    out = {"params": prepare_params(params, dtype=dtype, device=device)}
    if per_item:
        w, s = pack_encoder_weights(
            params["vit"], depth=depth, dtype=dtype, device=device,
            weight_dtype=torch.int8 if int8_weights else None)
        out.update(packed_w=w, packed_s=s)
    if batch_grid:
        bg_w, bg_s = pack_encoder_weights_batchgrid(
            params["vit"], depth=depth, dtype=dtype, device=device)
        out.update(bg_w=bg_w, bg_s=bg_s)
    if fold_ends and per_item:
        try:
            w_end, s_end, aux = pack_end_weights(params, dtype=dtype,
                                                 device=device)
        except ValueError as e:
            log.warning("lowlat fold-ends unavailable (%s) — serving "
                        "with the encoder-only kernel and plain ends", e)
            return out
        out.update(end_w=w_end, end_s=s_end, aux=aux)
    return out


@torch.inference_mode()
def serving_forward_lowlat(prepared, batch, *, num_heads: int = 12,
                           patch_size: int = 16, norm_eps: float = 1e-6,
                           dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """B = 1 regime: uint8 ``[B, H, W, 3]`` -> P(live) ``[B]`` with the
    whole forward in one launch.  With the fold-ends packs, patch
    extraction is the only work outside the kernel; otherwise the stem
    and the head run as in :func:`serving_forward` around the encoder-only
    kernel.  ``prepared``: :func:`prepare_lowlat`."""
    from ..ops.lowlat import forward_lowlat_e2e

    device = resolve_device(device)
    batch = _as_batch(batch, device)
    params = prepared["params"]
    if "aux" in prepared:
        h, w = batch.shape[1], batch.shape[2]
        gh, gw = h // patch_size, w // patch_size
        t = params["vit"]["pos_embed"].shape[-2]
        if gh * gw + 1 != t:
            raise ValueError(
                f"batch {h}x{w} yields {gh * gw + 1} tokens but the "
                f"prepared fold-ends packs hold a {t}-token pos embed "
                "(prepare_lowlat and the batch must share the image size)")
        x = patch_rows(batch, patch_size=patch_size,
                       tp=prepared["aux"].shape[1], dtype=dtype)
        logits = forward_lowlat_e2e(
            x, prepared["packed_w"], prepared["packed_s"],
            prepared["end_w"], prepared["end_s"], prepared["aux"],
            num_heads=num_heads, eps=norm_eps, valid_len=gh * gw + 1)
        return torch.sigmoid(logits[:, 1] - logits[:, 0])
    x = _lowlat_encode(prepared, batch, num_heads=num_heads,
                       patch_size=patch_size, norm_eps=norm_eps, dtype=dtype)
    return _cls_head_scores(params, x, norm_eps=norm_eps, dtype=dtype)


def _lowlat_encode(prepared, batch, *, num_heads: int, patch_size: int,
                   norm_eps: float, dtype) -> torch.Tensor:
    """Stem + the encoder-only kernel -> ``[B, Tp, D]`` stream."""
    from ..ops.lowlat import encoder_forward_lowlat

    x, t = padded_stream(prepared["params"]["vit"], batch, dtype=dtype,
                         patch_size=patch_size)
    return encoder_forward_lowlat(x, prepared["packed_w"],
                                  prepared["packed_s"], num_heads=num_heads,
                                  valid_len=t, eps=norm_eps)


@torch.inference_mode()
def serving_forward_lowlat_linear(prepared, batch, *, num_heads: int = 12,
                                  patch_size: int = 16,
                                  norm_eps: float = 1e-12,
                                  dtype=torch.bfloat16,
                                  device=None) -> torch.Tensor:
    """The B = 1 regime of the linear-head ViT: the stem, the whole
    encoder in one launch of the encoder-only kernel (the fold-ends packs
    hold the anti-spoof head, so :func:`prepare_lowlat` on this tree packs
    none), then the ends of :func:`serving_forward_linear` -> softmax
    ``[B, C]``.  ``prepared``: :func:`prepare_lowlat` of the folded
    linear-head tree."""
    device = resolve_device(device)
    batch = _as_batch(batch, device)
    x = _lowlat_encode(prepared, batch, num_heads=num_heads,
                       patch_size=patch_size, norm_eps=norm_eps, dtype=dtype)
    return _linear_head_probs(prepared["params"], x, norm_eps=norm_eps)


@torch.inference_mode()
def serving_forward_lowlat_batch(prepared, batch, *, num_heads: int = 12,
                                 patch_size: int = 16,
                                 norm_eps: float = 1e-6,
                                 dtype=torch.bfloat16, chunk_size: int = 2,
                                 device=None) -> torch.Tensor:
    """B = 2-16 regime: the stem, then the whole encoder in one launch per
    chunk of ``chunk_size`` (<= 4) items, each superblock read once a
    chunk; the batch is zero-padded to a whole number of chunks, and the
    head runs on the real items.  ``prepared``: :func:`prepare_lowlat`
    with ``batch_grid=True``."""
    from ..ops.lowlat import encoder_forward_lowlat_batchgrid

    device = resolve_device(device)
    batch = _as_batch(batch, device)
    params = prepared["params"]
    x, t = padded_stream(params["vit"], batch, dtype=dtype,
                         patch_size=patch_size)
    b = x.shape[0]
    chunk = min(b, chunk_size)
    bp = -(-b // chunk) * chunk
    x = F.pad(x, (0, 0, 0, 0, 0, bp - b))
    outs = [encoder_forward_lowlat_batchgrid(
        x[c:c + chunk].contiguous(), prepared["bg_w"], prepared["bg_s"],
        num_heads=num_heads, valid_len=t, eps=norm_eps)
        for c in range(0, bp, chunk)]
    x = torch.cat(outs)[:b]
    return _cls_head_scores(params, x, norm_eps=norm_eps, dtype=dtype)


def serving_program(model, *, mode: str, dtype=torch.bfloat16,
                    int8_weights: bool = False, device=None):
    """Resolve a serving regime to ``(weights, raw_fn, kwargs)``: read the
    module's weights into the JAX layout, fold the normalization into
    the patch-embed GEMM, and cast once for the per-layer kernels
    (``fastserve``) or pack for the whole-encoder ones (``lowlat``,
    ``batch_grid``).  ``int8_weights`` (``lowlat`` only) packs the opt-in
    int8 encoder stream (:func:`prepare_lowlat`)."""
    from .convert import antispoof_from_torch
    from .vit import ViTAntiSpoof, fold_normalization

    if not isinstance(model, ViTAntiSpoof):
        raise TypeError("serving programs run the anti-spoof head; got "
                        f"{type(model).__name__}")
    if int8_weights and mode != "lowlat":
        raise ValueError(
            "int8_weights quantizes the per-item lowlat weight stream; "
            f"mode={mode!r} amortizes weights across the batch and stays "
            "full-precision (pass mode='lowlat')")
    if mode not in ("fastserve", "lowlat", "batch_grid"):
        raise ValueError(f"unknown serving mode {mode!r}")
    device = resolve_device(device)
    geom = dict(num_heads=model.num_heads, patch_size=model.patch_size,
                norm_eps=model.norm_eps, dtype=dtype, device=device)
    variables = antispoof_from_torch(model.state_dict())
    folded = fold_normalization(variables)["params"]
    if mode == "fastserve":
        weights = prepare_params(folded, dtype=dtype, device=device)
        return weights, serving_forward, dict(geom, depth=model.depth)
    prepared = prepare_lowlat(folded, depth=model.depth, dtype=dtype,
                              batch_grid=(mode == "batch_grid"),
                              per_item=(mode == "lowlat"),
                              int8_weights=int8_weights, device=device)
    raw = (serving_forward_lowlat_batch if mode == "batch_grid"
           else serving_forward_lowlat)
    return prepared, raw, geom


def auto_serving_mode(batch_size: int) -> str:
    """The regime table measured on the H100 (``NVIDIA H100 80GB HBM3``,
    700 W; ``chip_smoke.py``'s ``times_small`` phase, which times each
    regime at B = 1, 2, 4, 8, 16): B = 1 ``lowlat`` (1.02 ms a forward,
    fastserve 2.32), B = 2 ``batch_grid`` (1.46 ms a forward against
    fastserve's 2.30), B >= 3 ``fastserve`` (at B = 4, 8, 16 2.18, 2.46
    and 3.43 ms a forward against ``batch_grid``'s 2.71, 5.22 and 10.36:
    one launch a 2-item chunk, about 1.3 ms each).  The JAX package's TPU
    table serves B = 2-16 on ``batch_grid``; ``make_serving_fn(mode=...)``
    still picks any regime explicitly."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if batch_size == 1:
        return "lowlat"
    return "batch_grid" if batch_size == 2 else "fastserve"


def make_serving_fn(model, *, batch_size: int, mode: str = "auto",
                    dtype=torch.bfloat16, int8_weights: bool = False,
                    device=None):
    """Serving factory: fold normalization, cast or pack the weights once,
    and return ``uint8 [B, H, W, 3] -> P(live) [B]`` (an f32 tensor on the
    device) on the regime for ``batch_size`` (:func:`auto_serving_mode`:
    B = 1 ``lowlat``, >= 2 ``fastserve``); ``mode`` overrides it.

    ``model``: the port's ``ViTAntiSpoof`` holding its unfolded weights.
    Runs on the card unless ``device="cpu"``, and raises when no card is
    present and the CPU was not asked for."""
    device = resolve_device(device)
    if mode == "auto":
        mode = auto_serving_mode(batch_size)
    weights, raw, kw = serving_program(model, mode=mode, dtype=dtype,
                                       int8_weights=int8_weights,
                                       device=device)
    return lambda batch_u8: raw(weights, batch_u8, **kw)
