"""ViT-B/16 backbone + anti-spoofing head, and the linear-head ablation,
as ``nn.Module``s (counterpart of the JAX package's ``models/vit.py``).

The modules carry the published checkpoint's key set: ``vit.<timm
names>`` (``patch_embed.proj`` as a 16x16/stride-16 conv, fused
``blocks.i.attn.qkv``) plus the head as ``classifier.{0,2,5}``
(LayerNorm, Linear(768, 512), Linear(512, 2) of an ``nn.Sequential``).
A state dict from the JAX exporter (``models/convert.py``) therefore
loads with ``strict=True``.  :class:`ViTLinearHead` is ``vit.*`` plus a
bare ``classifier`` Linear.

``dtype`` is flax's compute policy: the parameters stay f32 and are
cast to ``dtype`` where they are used.  A Linear rounds its product to
``dtype`` and then adds the bias in ``dtype``; a LayerNorm takes its
statistics in f32 and writes ``dtype``; the softmax is f32; the GELU
rounds where XLA's does; the features reach the head in f32,
and the head's last Linear computes in f32.  The patch embed is the
conv's weights as one GEMM over :func:`patchify`'s rows, as in JAX.

The attention core goes through ``ops/attention.py::
dispatch_attention_qkv``: kernel 8 (``csrc/attention_qkv.cu``) on a CUDA
tensor, its plain version on a CPU one.  The dense einsum path remains
only for ``capture=True``, the attention-map tap.

Under a mesh (``ops/attention.py::attention_sharding``, one process per
rank): with a ``seq`` axis, :class:`ViT` pads the tokens to a multiple
of ``8 n_seq`` and runs the blocks on this rank's contiguous block of
them, the attention on kernel 12 against the gathered keys (the mean
pooling sums each rank's real tokens and adds the sums over the group);
the heads' logits are seq rank 0's (the CLS token lives there), on every
rank of the sequence group, with their gradient on seq rank 0 only, so
each image's loss counts once.  With a ``model`` axis (Megatron tensor
parallelism, ``parallel/mesh.py::shard_params``) each layer holds this
rank's columns of qkv and fc1 and its rows of proj and fc2: the
attention runs kernel 8 on the rank's heads, and each sub-layer's
partial sums are all-reduced once, the bias added after.  With a
``data`` axis the head's dropout masks are drawn at the global batch
shape and this rank's rows kept, so a run replays the single-card masks
(the same masks on every model and pipe rank of a data group).  The serving path
(``models/fastserve.py``) runs the same function on the block kernels
over weights from :func:`fold_normalization`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as att
from ..ops.gelu import _SQRT_2_OVER_PI, _SQRT_HALF, GELU, gelu
from ..ops.image import IMAGENET_MEAN, IMAGENET_STD
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, axis_rank,
                             axis_sizes)


def _dense(x, weight, bias, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` over a torch ``[out, in]`` weight:
    the product rounded to ``dtype``, then the bias added in ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


def _linear(x, layer: nn.Linear, dtype) -> torch.Tensor:
    return _dense(x, layer.weight, layer.bias, dtype)


def _layer_norm(x, layer: nn.LayerNorm, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: f32 statistics and affine, the
    output in ``dtype``."""
    return F.layer_norm(x.float(), layer.normalized_shape,
                        layer.weight.float(), layer.bias.float(),
                        layer.eps).to(dtype)


def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """``jax.nn.gelu`` in ``x.dtype`` with XLA's rounding points: f32 as
    ``ops/gelu.py`` writes it; below f32 the constants rounded to the
    dtype, the tanh form op by op, and the exact form's ``erfc`` taken in
    f32 of the unrounded ``-x * sqrt(1/2)``, rounded, then multiplied by
    ``0.5 x``."""
    if x.dtype == torch.float32:
        return gelu(x, approximate)
    dt = x.dtype

    def c(v):
        return float(torch.tensor(v).to(dt))

    if approximate:
        inner = c(_SQRT_2_OVER_PI) * (x + c(0.044715) * x ** 3)
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    return (0.5 * x) * torch.erfc(-x.float() * c(_SQRT_HALF)).to(dt)


def _mesh_axes():
    """``(mesh, {axis: size})`` of the enclosing ``attention_sharding``
    (``(None, {})`` on the single-card path)."""
    mesh = att.current_mesh()
    return (None, {}) if mesh is None else (mesh, axis_sizes(mesh))


def _dropout_rows(drop: nn.Dropout, x: torch.Tensor) -> torch.Tensor:
    """``drop(x)`` over this rank's rows ``x [B_l, F]`` as the single-card
    run over the global batch draws it: under a data axis of n ranks the
    mask comes from a ``[n B_l, F]`` tensor (the same generator state on
    every rank) holding ``x`` at this rank's block, and the block is
    kept."""
    mesh, sizes = _mesh_axes()
    n = sizes.get(DATA_AXIS, 1)
    if not (drop.training and drop.p > 0 and n > 1):
        return drop(x)
    b = x.shape[0]
    lo = axis_rank(mesh, DATA_AXIS) * b
    full = F.pad(x, (0, 0, lo, (n - 1) * b - lo))
    return drop(full)[lo:lo + b]


def _seq_logits(logits: torch.Tensor) -> torch.Tensor:
    """Under a seq axis: seq rank 0's logits (its row 0 is the CLS token)
    on every rank of the sequence group, the gradient on seq rank 0
    only."""
    mesh, sizes = _mesh_axes()
    if sizes.get(SEQ_AXIS, 1) == 1:
        return logits
    from ..parallel.collectives import from_seq_rank0
    return from_seq_rank0(logits, mesh.get_group(SEQ_AXIS))


def _model_group(split: bool):
    """The model group of the enclosing mesh when a sub-layer is split over
    it (None on the single-card path or with the sub-layer kept whole)."""
    mesh, sizes = _mesh_axes()
    if sizes.get(MODEL_AXIS, 1) == 1 or not split:
        return None
    return mesh.get_group(MODEL_AXIS)


def _check_local(layer: nn.Linear, full: int, n: int, what: str):
    """Under a model axis the column-split product must hold this rank's
    ``full / n`` output columns (``parallel/mesh.py::shard_params``)."""
    if layer.weight.shape[0] != full // n:
        raise ValueError(
            f"{what} holds {layer.weight.shape[0]} output columns under a "
            f"{n}-way model axis; expected this rank's {full // n} "
            "(lay the parameters out with parallel.mesh.shard_params)")


def _row_split(x, layer: nn.Linear, dtype, group) -> torch.Tensor:
    """A row-split product: this rank's partial sums in ``dtype``, summed
    over the model group, then the bias once."""
    from ..parallel.collectives import reduce_from_group
    part = F.linear(x.to(dtype), layer.weight.to(dtype))
    return reduce_from_group(part, group) + layer.bias.to(dtype)


def _single_device() -> bool:
    """No process group of more than one rank (JAX's
    ``jax.device_count() == 1``: a kernel per device, nothing sharded)."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def dot_product_attention(q, k, v, *, dtype=torch.float32, use_fused=None):
    """Attention core over ``[B, T, H, Dh]`` inputs, softmax in f32 (JAX
    :38).  ``use_fused=None`` takes kernel 9 (``ops/attention.py::
    fused_attention``) on a CUDA tensor on a single device and the dense
    einsum path otherwise; ``use_fused=True`` takes ``fused_attention``
    on any device (its plain version on the CPU)."""
    if use_fused is None:
        use_fused = q.device.type == "cuda" and _single_device()
    if use_fused:
        return att.fused_attention(q, k, v)
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    weights = torch.softmax(logits * float(dh) ** -0.5, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(torch.promote_types(dtype, v.dtype))


class Attention(nn.Module):
    """Multi-head self-attention with a fused QKV projection; the core
    goes through ``dispatch_attention_qkv``.  ``capture=True`` takes the
    dense einsum path instead and keeps the f32 softmax ``[B, H, T, T]``
    in :attr:`attn_probs` (the JAX ``sow`` of the attention-map tap)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 capture: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} is not divisible by "
                             f"num_heads={num_heads}")
        self.num_heads, self.dtype, self.capture = num_heads, dtype, capture
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.attn_probs = None

    def forward(self, x: torch.Tensor, valid_len=None) -> torch.Tensor:
        """``valid_len``: under a seq mesh, the real token count of the
        whole stream (``x`` is this rank's block of it).  Under a model
        axis of n ranks that divides the heads, ``qkv`` and ``proj`` hold
        this rank's heads: the input's gradient is summed over the model
        group, kernel 8 runs on the rank's H / n heads, and proj's partial
        sums are all-reduced before its bias."""
        b, t, d = x.shape
        mesh, sizes = _mesh_axes()
        n = sizes.get(MODEL_AXIS, 1)
        group = _model_group(self.num_heads % n == 0)
        if n > 1 and self.capture:
            raise ValueError("capture_attention reads the whole attention "
                             "map, which no rank holds under a model axis")
        if group is not None:
            from ..parallel.collectives import copy_to_group
            _check_local(self.qkv, 3 * d, n, "attn.qkv")
            x = copy_to_group(x, group)
        qkv = _linear(x, self.qkv, self.dtype)          # [B, T, 3D(/n)]
        if self.capture:
            dh = d // self.num_heads
            q, k, v = qkv.view(b, t, 3, self.num_heads, dh).unbind(2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            weights = torch.softmax(logits * dh ** -0.5, dim=-1)
            self.attn_probs = weights
            out = torch.einsum("bhqk,bkhd->bqhd", weights.to(self.dtype), v)
            out = out.reshape(b, t, d)
        else:
            out = att.dispatch_attention_qkv(qkv, self.num_heads,
                                             valid_len=valid_len)
        if group is not None:
            return _row_split(out, self.proj, self.dtype, group)
        return _linear(out, self.proj, self.dtype)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, gelu: str = "erf",
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.hidden_dim = dtype, hidden_dim
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.act = GELU(approximate=gelu == "tanh")
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under a model axis of n ranks that divides the hidden width,
        fc1 holds this rank's hidden columns and fc2 its rows: the input's
        gradient is summed over the model group and fc2's partial sums are
        all-reduced before its bias."""
        n = _mesh_axes()[1].get(MODEL_AXIS, 1)
        group = _model_group(self.hidden_dim % n == 0)
        if group is not None:
            from ..parallel.collectives import copy_to_group
            _check_local(self.fc1, self.hidden_dim, n, "mlp.fc1")
            x = copy_to_group(x, group)
        h = _gelu(_linear(x, self.fc1, self.dtype), self.act.approximate)
        if group is not None:
            return _row_split(h, self.fc2, self.dtype, group)
        return _linear(h, self.fc2, self.dtype)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block (timm ViT layout)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, gelu: str = "erf",
                 dtype=torch.float32, capture_attention: bool = False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, dtype, capture_attention)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), gelu, dtype)

    def forward(self, x: torch.Tensor, valid_len=None) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.norm1, self.dtype), valid_len)
        return x + self.mlp(_layer_norm(x, self.norm2, self.dtype))


def patchify(x: torch.Tensor, *, patch_size: int, dtype) -> torch.Tensor:
    """``[B, H, W, C]`` image -> ``[B, gh*gw, p*p*C]`` patch rows in
    (row, column, channel) order: the ViT stem's im2row, the layout of
    the serving path's patch-embed GEMM."""
    b, h, w, c = x.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = x.to(dtype).reshape(b, gh, p, gw, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)


class PatchEmbed(nn.Module):
    """timm's ``patch_embed``: a stride-p conv, computed as the JAX
    package computes it, one GEMM over :func:`patchify`'s rows ->
    ``[B, gh*gw, D]`` tokens in ``dtype``."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        w = self.proj.weight                                   # [D, C, p, p]
        rows = patchify(x, patch_size=w.shape[-1], dtype=dtype)
        return _dense(rows, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                      self.proj.bias, dtype)


class ViT(nn.Module):
    """ViT backbone returning pooled features after the final LayerNorm
    (timm ``num_classes=0``), in ``dtype``: the CLS token
    (``pool="token"``) or the mean of the patch tokens (``"mean"``)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, norm_eps: float = 1e-6,
                 gelu: str = "erf", img_size: int = 224,
                 in_chans: int = 3, pool: str = "token",
                 dtype=torch.float32, capture_attention: bool = False):
        super().__init__()
        if pool not in ("token", "mean"):
            raise ValueError(f"pool must be 'token' or 'mean', got {pool!r}")
        self.pool, self.dtype = pool, dtype
        n_tokens = (img_size // patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_ratio, norm_eps, gelu,
                         dtype, capture_attention)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, H, W, 3]`` float (already normalized) -> ``[B, D]``."""
        dt = self.dtype
        x = self.patch_embed(x, dt)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        mesh, sizes = _mesh_axes()
        n_seq = sizes.get(SEQ_AXIS, 1)
        if n_seq > 1:
            return self._forward_seq(x, mesh, n_seq)
        for blk in self.blocks:
            x = blk(x)
        x = _layer_norm(x, self.norm, dt)
        if self.pool == "token":
            return x[:, 0]
        return x[:, 1:].float().mean(1).to(dt)

    def _forward_seq(self, x, mesh, n_seq: int) -> torch.Tensor:
        """The blocks on this rank's block of the tokens (JAX
        ``_sp_sharded`` :1024 shards the same stream): ``[B, T, D]``
        padded to ``Tp = round_up(T, 8 n_seq)`` (197 -> 208 at two ranks,
        224 at four, 256 at eight), rows ``r Tp / n .. (r + 1) Tp / n``
        kept.  LayerNorm, the GEMMs and the MLP are token-local; pad rows
        run through them (a zero row's LayerNorm is finite), are masked
        as keys and never read as outputs.  ``pool="token"`` returns row
        0 of the block after the final LayerNorm: the CLS feature on seq
        rank 0.  ``pool="mean"``: each rank sums its real patch rows
        (global rows 1 .. T-1) in f32 after the final LayerNorm, the
        sums and the row counts are summed over the sequence group
        (``parallel/collectives.py::psum``), and every rank divides: the
        mean of JAX's ``x[:, 1:]``."""
        if any(blk.attn.capture for blk in self.blocks):
            raise ValueError("capture_attention reads the whole attention "
                             "map, which no rank holds under a seq axis")
        t = x.shape[1]
        tl = att._round_up(t, 8 * n_seq) // n_seq
        lo = axis_rank(mesh, SEQ_AXIS) * tl
        x = F.pad(x, (0, 0, 0, n_seq * tl - t))[:, lo:lo + tl]
        for blk in self.blocks:
            x = blk(x, valid_len=t)
        x = _layer_norm(x, self.norm, self.dtype)
        if self.pool == "token":
            return x[:, 0]
        from ..parallel.collectives import psum
        group = mesh.get_group(SEQ_AXIS)
        a, b = max(1, lo), min(t, lo + tl)            # this block's real
        sums = x[:, a - lo:max(a, b) - lo].float().sum(1)   # patch rows
        count = torch.tensor([float(max(0, b - a))], device=x.device)
        sums = psum(sums, group)
        count = psum(count, group)
        return (sums / count).to(self.dtype)


class AntiSpoofHead(nn.Sequential):
    """LayerNorm(eps 1e-5) -> Dropout -> Linear(D, hidden) -> exact GELU
    -> Dropout -> Linear(hidden, classes): indices 0..5, the reference's
    ``classifier`` Sequential.  Computes in ``dtype`` but for the last
    Linear, which is f32 (the JAX head's f32 logits)."""

    def __init__(self, dim: int = 768, hidden: int = 512,
                 num_classes: int = 2, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__(nn.LayerNorm(dim, eps=1e-5), nn.Dropout(dropout),
                         nn.Linear(dim, hidden), GELU(approximate=False),
                         nn.Dropout(dropout), nn.Linear(hidden, num_classes))
        self.dtype = dtype

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        norm, drop1, fc1, _act, drop2, fc2 = self
        x = _dropout_rows(drop1, _layer_norm(feats, norm, self.dtype))
        x = _gelu(_linear(x, fc1, self.dtype), approximate=False)
        return _linear(_dropout_rows(drop2, x), fc2, torch.float32)


class ViTAntiSpoof(nn.Module):
    """Flagship model: ViT-B/16 features + the anti-spoofing MLP head."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, hidden: int = 512,
                 num_classes: int = 2, dropout: float = 0.1,
                 norm_eps: float = 1e-6, gelu: str = "erf",
                 img_size: int = 224, dtype=torch.float32,
                 pool: str = "token", capture_attention: bool = False):
        super().__init__()
        if gelu not in ("erf", "tanh"):
            raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
        self.patch_size, self.embed_dim, self.depth = (patch_size,
                                                       embed_dim, depth)
        self.num_heads, self.norm_eps = num_heads, norm_eps
        self.gelu, self.dropout, self.dtype = gelu, dropout, dtype
        self.vit = ViT(patch_size, embed_dim, depth, num_heads, mlp_ratio,
                       norm_eps, gelu, img_size, pool=pool, dtype=dtype,
                       capture_attention=capture_attention)
        self.classifier = AntiSpoofHead(embed_dim, hidden, num_classes,
                                        dropout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, H, W, 3]`` normalized float -> logits ``[B, classes]``
        (f32)."""
        return _seq_logits(self.classifier(self.vit(x).float()))


class ViTLinearHead(nn.Module):
    """ViT + a bare f32 linear head on CLS: the frozen "Base ViT"
    ablation (HF ViTForImageClassification, LayerNorm eps 1e-12; JAX
    ``models/vit.py:307``).  ViT-B/16 unless told otherwise."""

    def __init__(self, num_classes: int = 2, dtype=torch.float32, *,
                 patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 img_size: int = 224):
        super().__init__()
        self.patch_size, self.embed_dim, self.depth = (patch_size,
                                                       embed_dim, depth)
        self.num_heads, self.norm_eps, self.dtype = num_heads, 1e-12, dtype
        self.vit = ViT(patch_size, embed_dim, depth, num_heads,
                       norm_eps=1e-12, img_size=img_size, dtype=dtype)
        self.classifier = nn.Linear(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _seq_logits(_linear(self.vit(x).float(), self.classifier,
                                   torch.float32))


def module_apply(module: nn.Module):
    """flax's ``module.apply`` for a port module: ``apply_fn(variables,
    x)`` runs the module's forward on ``variables["params"]``, a state
    dict under the module's own key names (``dict(module.
    named_parameters())``), in eval mode."""
    def apply_fn(variables, x):
        module.eval()
        return torch.func.functional_call(module, variables["params"], (x,))
    return apply_fn


def fold_normalization(variables, *, mean=None, std=None,
                       input_scale: float = 255.0):
    """Fold ToTensor (/255) and the ImageNet normalization into the
    patch-embed GEMM of a JAX-layout parameter tree (``{"params": {"vit":
    {"patch_embed": {"kernel": [p*p*c, D], "bias": [D]}, ...}}}``), so the
    model takes raw uint8 images.

    For row i of the patch kernel (channel c = i % 3):
      y = sum_i ((u_i/s - m_c)/sd_c) k_i + b
        = sum_i u_i * k_i/(s*sd_c)  +  (b - sum_i (m_c/sd_c) k_i)

    Computed in f32; the folded leaves are tensors of the input leaves'
    dtypes.  Returns a new tree; the input is not modified."""
    f32 = torch.float32
    mean = torch.tensor(IMAGENET_MEAN if mean is None else mean, dtype=f32)
    std = torch.tensor(IMAGENET_STD if std is None else std, dtype=f32)

    params = dict(variables["params"])
    inner = dict(params["vit"]) if "vit" in params else params
    pe = inner["patch_embed"]
    k0, b0 = (t if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
              for t in (pe["kernel"], pe["bias"]))
    k = k0.to(device="cpu", dtype=f32)                   # [p*p*c, D]
    b = b0.to(device="cpu", dtype=f32)
    reps = k.shape[0] // mean.shape[0]                   # c is fastest
    scale = (1.0 / (input_scale * std)).repeat(reps)
    shift = (mean / std).repeat(reps)
    inner["patch_embed"] = {
        "kernel": (k * scale[:, None]).to(device=k0.device, dtype=k0.dtype),
        "bias": (b - shift @ k).to(device=b0.device, dtype=b0.dtype)}
    if "vit" in params:
        params["vit"] = inner
    out = dict(variables)
    out["params"] = params
    return out
