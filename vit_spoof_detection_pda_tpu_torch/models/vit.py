"""ViT-B/16 backbone + anti-spoofing head as ``nn.Module``s (counterpart
of the JAX package's ``models/vit.py``).

The modules carry the published checkpoint's key set: ``vit.<timm
names>`` (``patch_embed.proj`` as a 16x16/stride-16 conv, fused
``blocks.i.attn.qkv``) plus the head as ``classifier.{0,2,5}``
(LayerNorm, Linear(768, 512), Linear(512, 2) of an ``nn.Sequential``).
A state dict from the JAX exporter (``models/convert.py``) therefore
loads with ``strict=True``.

This is the port's plain whole-model reference: dense attention with an
f32 softmax, and ``torch.nn.functional`` everywhere.  The serving path
(``models/fastserve.py``) runs the same function on the hand-written
kernels over weights from :func:`fold_normalization`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.gelu import GELU
from ..ops.image import IMAGENET_MEAN, IMAGENET_STD


class Attention(nn.Module):
    """Multi-head self-attention with a fused QKV projection (dense
    path: f32 logits and softmax, weights cast back to the input dtype
    before ``@ v``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} is not divisible by "
                             f"num_heads={num_heads}")
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // self.num_heads
        q, k, v = self.qkv(x).view(b, t, 3, self.num_heads, dh).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits * dh ** -0.5, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.proj(out.reshape(b, t, d))


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, gelu: str = "erf"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.act = GELU(approximate=gelu == "tanh")
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block (timm ViT layout)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-6, gelu: str = "erf"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


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
    """timm's ``patch_embed``: a stride-p conv over NHWC input, flattened
    to ``[B, gh*gw, D]`` tokens."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x.permute(0, 3, 1, 2))
        return y.flatten(2).transpose(1, 2)


class ViT(nn.Module):
    """ViT backbone returning pooled CLS features after the final
    LayerNorm (timm ``num_classes=0``)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, norm_eps: float = 1e-6,
                 gelu: str = "erf", img_size: int = 224,
                 in_chans: int = 3):
        super().__init__()
        n_tokens = (img_size // patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_ratio, norm_eps, gelu)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, H, W, 3]`` float (already normalized) -> ``[B, D]``."""
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]


class AntiSpoofHead(nn.Sequential):
    """LayerNorm(eps 1e-5) -> Dropout -> Linear(D, hidden) -> exact GELU
    -> Dropout -> Linear(hidden, classes): indices 0..5, the reference's
    ``classifier`` Sequential."""

    def __init__(self, dim: int = 768, hidden: int = 512,
                 num_classes: int = 2, dropout: float = 0.1):
        super().__init__(nn.LayerNorm(dim, eps=1e-5), nn.Dropout(dropout),
                         nn.Linear(dim, hidden), GELU(approximate=False),
                         nn.Dropout(dropout), nn.Linear(hidden, num_classes))


class ViTAntiSpoof(nn.Module):
    """Flagship model: ViT-B/16 features + the anti-spoofing MLP head."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, hidden: int = 512,
                 num_classes: int = 2, dropout: float = 0.1,
                 norm_eps: float = 1e-6, gelu: str = "erf",
                 img_size: int = 224):
        super().__init__()
        if gelu not in ("erf", "tanh"):
            raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
        self.patch_size, self.embed_dim, self.depth = (patch_size,
                                                       embed_dim, depth)
        self.num_heads, self.norm_eps = num_heads, norm_eps
        self.gelu, self.dropout = gelu, dropout
        self.vit = ViT(patch_size, embed_dim, depth, num_heads, mlp_ratio,
                       norm_eps, gelu, img_size)
        self.classifier = AntiSpoofHead(embed_dim, hidden, num_classes,
                                        dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, H, W, 3]`` normalized float -> logits ``[B, classes]``
        (f32)."""
        return self.classifier(self.vit(x).float())


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
