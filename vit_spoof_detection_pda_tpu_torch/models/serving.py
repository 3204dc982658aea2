"""int8 serving path for the ViT (counterpart of the JAX package's
``models/serving.py``): an opt-in capability, not the serving default.

Per-output-channel symmetric int8 weights (offline,
:func:`quantize_vit_params`), dynamic per-token symmetric int8
activations, int32 sums rescaled in f32; LayerNorm, GELU and the residual
stream in f32; the attention core in bf16 on kernel 9
(``ops/attention.py::fused_attention``, ``csrc/attention.cu``) on the
card and its plain version on the CPU.  The JAX package measured this
path slower than bf16 serving on its chip; the port's times are in
``PERF.md``.

The int8 x int8 -> int32 products are one library call,
``torch._int_mm`` (XLA's ``dot_general`` in the JAX package, outside any
kernel): on the CPU as it is, on the card through cuBLASLt, which takes
more than 16 rows and inner and output widths that are multiples of 8, so
the operands are zero-padded there (exact) and the result cut back.  The
order of operations is JAX's: ``(acc * s) * scale + bias``, round half to
even, the 1e-8 floors.

The parameter tree is the JAX layout (``{"vit": {"block0": ...},
"head": ...}``, ``[in, out]`` kernels), the tree ``pack_encoder_weights``
also takes, so the same tree feeds both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import attention as att
from ..ops.gelu import gelu
from .vit import patchify


def _f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


# --------------------------------------------------------------------------
# Quantization
# --------------------------------------------------------------------------


def quantize_dense(kernel, bias=None, *, device=None) -> Dict[str, Any]:
    """Per-output-channel symmetric int8: ``q = round(w / s)``,
    ``s = max(amax / 127, 1e-8)``, on ``device`` (the card unless
    ``"cpu"``)."""
    device = resolve_device(device)
    kernel = _f32(kernel, device)
    scale = torch.clamp(kernel.abs().amax(dim=0) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    out = {"q": q.contiguous(), "scale": scale}
    if bias is not None:
        out["bias"] = _f32(bias, device)
    return out


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8 -> [M, N] int32``.  On the card
    the operands are zero-padded to cuBLASLt's shapes (M > 16, K and N
    multiples of 8): the padded rows and columns add 0."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def dense_int8(x, qw) -> torch.Tensor:
    """``y = dequant(int8(x) @ q) + bias`` with dynamic per-row activation
    scales.  ``x [..., in]`` float; returns f32 ``[..., out]``."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    lead = xq.shape[:-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), qw["q"])
    y = acc.reshape(*lead, acc.shape[-1]).float() * s * qw["scale"]
    if "bias" in qw:
        y = y + qw["bias"]
    return y


def quantize_vit_params(params: Dict[str, Any], depth: int = 12, *,
                        device=None) -> Dict:
    """ViTAntiSpoof float params (the JAX-layout tree) -> int8 serving
    params on ``device`` (the card unless ``"cpu"``).

    Quantized: patch_embed, per-block qkv/proj/fc1/fc2, head fc1/fc2.
    Kept f32: LayerNorms, cls_token, pos_embed."""
    device = resolve_device(device)
    vit = params["vit"]

    def qd(p):
        return quantize_dense(p["kernel"], p["bias"], device=device)

    def ln(p):
        return {"scale": _f32(p["scale"], device),
                "bias": _f32(p["bias"], device)}

    out = {"patch_embed": qd(vit["patch_embed"]),
           "cls_token": _f32(vit["cls_token"], device),
           "pos_embed": _f32(vit["pos_embed"], device),
           "norm": ln(vit["norm"]), "blocks": []}
    for i in range(depth):
        b = vit[f"block{i}"]
        out["blocks"].append({
            "norm1": ln(b["norm1"]), "qkv": qd(b["attn"]["qkv"]),
            "proj": qd(b["attn"]["proj"]), "norm2": ln(b["norm2"]),
            "fc1": qd(b["mlp"]["fc1"]), "fc2": qd(b["mlp"]["fc2"])})
    head = params["head"]
    out["head"] = {"norm": ln(head["norm"]), "fc1": qd(head["fc1"]),
                   "fc2": qd(head["fc2"])}
    return out


# --------------------------------------------------------------------------
# Inference forward
# --------------------------------------------------------------------------


def _layernorm(x, p, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)) * p["scale"] + p["bias"]


@torch.inference_mode()
def vit_antispoof_int8_apply(qp: Dict, x, *, num_heads: int = 12,
                             patch_size: int = 16,
                             norm_eps: float = 1e-6) -> torch.Tensor:
    """Quantized inference forward: ``x [B, H, W, 3]`` normalized floats
    (on the device of ``qp``) -> f32 logits ``[B, num_classes]``.  The
    attention core is kernel 9 in bf16 (12 launches a forward at depth
    12) on the card, its plain version on the CPU."""
    b = x.shape[0]
    x = patchify(x, patch_size=patch_size, dtype=torch.float32)
    x = dense_int8(x, qp["patch_embed"])
    d = x.shape[-1]
    cls = qp["cls_token"].reshape(1, 1, d).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + qp["pos_embed"].reshape(1, -1, d)
    t = x.shape[1]
    dh = d // num_heads
    for blk in qp["blocks"]:
        y = _layernorm(x, blk["norm1"], norm_eps)
        qkv = dense_int8(y, blk["qkv"]).to(torch.bfloat16)
        q, k, v = qkv.reshape(b, t, 3, num_heads, dh).unbind(2)
        attn = att.fused_attention(q, k, v).reshape(b, t, d)
        x = x + dense_int8(attn, blk["proj"])
        y = _layernorm(x, blk["norm2"], norm_eps)
        y = gelu(dense_int8(y, blk["fc1"]), approximate=False)
        x = x + dense_int8(y, blk["fc2"])
    x = _layernorm(x, qp["norm"], norm_eps)
    y = _layernorm(x[:, 0], qp["head"]["norm"], 1e-5)
    y = gelu(dense_int8(y, qp["head"]["fc1"]), approximate=False)
    return dense_int8(y, qp["head"]["fc2"])
