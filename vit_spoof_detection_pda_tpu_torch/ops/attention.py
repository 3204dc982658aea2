"""The ViT's two serving sub-layers as hand-written CUDA kernels
(counterpart of the JAX package's ``ops/attention.py`` serving kernels).

- :func:`fused_attention_block_padded`:
  ``x + proj(MHA(LN1(x) @ Wqkv + bqkv)) + bproj`` over a padded
  ``[B, Tp, D]`` stream, key columns at or past ``valid_len`` masked.
  Kernel: ``csrc/attention_block.cu``; replaces the TPU kernel
  ``_attn_block_kernel`` (JAX ``ops/attention.py:412``).
- :func:`fused_mlp_block`: ``x + fc2(gelu_tanh(fc1(LN2(x))))`` over the
  flat rows.  Kernel: ``csrc/mlp_block.cu``; replaces ``_mlp_block_kernel``
  (JAX ``ops/attention.py:532``).

Each wrapper takes the JAX layouts (``[in, out]`` kernels, f32 LN and
bias vectors).  A CPU tensor goes to the plain PyTorch version beside it
(``*_plain``); a CUDA tensor goes to the kernel, which takes bf16
activations and weights and raises on anything else.  ``LAUNCHES``
counts the kernel calls (one per wrapper call on the card), so a run can
show that its main path went through the kernels.

Both kernels are bound by the tensor cores on the H100; the source notes
in ``csrc/`` give the bounds and what the first design does about them.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import exact_f32_matmul
from . import _build
from .gelu import gelu

LAUNCHES = {"attention_block": 0, "mlp_block": 0}
_MAX_SMEM = 232448          # dynamic shared memory one H100 block may use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "attention_block": ("vsd_attention_block",
                        [_P] * 10 + [_I] * 5 + [_F, _F, _P]),
    "mlp_block": ("vsd_mlp_block", [_P] * 10 + [_I] * 3 + [_F, _P]),
}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_head_geometry(width: int, num_heads: int, *, fused: int = 1):
    """Validate a (possibly fused) stream width against the head count;
    returns the embed dim."""
    if width % fused:
        raise ValueError(
            f"fused stream width {width} is not divisible by {fused}")
    d = width // fused
    if d % num_heads:
        raise ValueError(
            f"embed dim {d} is not divisible by num_heads={num_heads} — "
            "per-head slices would leave output columns unwritten")
    return d


def _entry(name: str):
    lib = _build.load(name)
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _require(t: torch.Tensor, what: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} is {t.dtype}; the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def _layernorm_f32(x32, scale, bias, eps):
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    xn = (x32 - mu) * torch.rsqrt(var + eps)
    return xn * scale.float() + bias.float()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of (possibly bf16) operands: exact upcasts, f32 sums."""
    return torch.matmul(a.float(), b.float())


# --------------------------------------------------------------------------
# Attention block
# --------------------------------------------------------------------------


def fused_attention_block_padded_plain(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_proj, b_proj, num_heads: int, *,
                                       valid_len: int, eps: float = 1e-6):
    """Plain PyTorch version of the attention-block kernel, rounding where
    the TPU kernel does (to ``xp.dtype``): xn, qkv, the softmax weights
    and the concatenated head outputs; everything else in f32."""
    b, tp, d = xp.shape
    d = _check_head_geometry(d, num_heads)
    dh = d // num_heads
    cdt = xp.dtype
    scale = float(dh) ** -0.5
    with exact_f32_matmul():
        x = xp.float()
        xn = _layernorm_f32(x, ln_scale, ln_bias, eps).to(cdt)
        qkv = (_mm(xn, w_qkv) + b_qkv.float()).to(cdt)
        q, k, v = qkv.view(b, tp, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
        logits = _mm(q, k.transpose(-1, -2)) * scale          # [B,H,Tp,Tp]
        keep = torch.arange(tp, device=xp.device) < valid_len
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1)
        heads = _mm(w.to(cdt), v)                              # [B,H,Tp,dh]
        attn = heads.permute(0, 2, 1, 3).reshape(b, tp, d).to(cdt)
        return (x + _mm(attn, w_proj) + b_proj.float()).to(cdt)


def fused_attention_block_padded(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                 w_proj, b_proj, num_heads: int, *,
                                 valid_len: int, eps: float = 1e-6):
    """Padded-stream form: ``xp [B, Tp, D]`` with ``valid_len`` real
    tokens -> ``[B, Tp, D]``.  Pad rows are computed as real rows (their
    keys are masked like every other row's); slice them off after the
    last layer.

    On the card: bf16 ``xp``, ``w_qkv [D, 3D]`` and ``w_proj [D, D]``;
    f32 ``ln_scale``, ``ln_bias``, ``b_qkv`` and ``b_proj``; any B,
    ``Tp % 8 == 0`` (up to 800 at head dim 64, where one head's K and V
    stop fitting in shared memory) and a head dim that is a multiple of
    16 up to 128."""
    if xp.device.type == "cpu":
        return fused_attention_block_padded_plain(
            xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
            valid_len=valid_len, eps=eps)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    b, tp, d = xp.shape
    d = _check_head_geometry(d, num_heads)
    dh = d // num_heads
    if dh % 16 or dh > 128 or tp % 8 or not 0 <= valid_len <= tp:
        raise ValueError(
            f"the attention kernel takes a head dim that is a multiple of "
            f"16 up to 128, Tp % 8 == 0 and 0 <= valid_len <= Tp; got head "
            f"dim {dh}, Tp {tp}, valid_len {valid_len}")
    smem = 2 * _round_up(tp, 16) * (dh + 8) * 2            # K and V
    if smem > _MAX_SMEM:
        raise ValueError(f"Tp {tp} at head dim {dh} needs {smem} bytes of "
                         f"shared memory per block; the card has {_MAX_SMEM}")
    if not 0 < b <= 65535 or num_heads > 65535:
        raise ValueError(f"batch {b} / heads {num_heads} outside the grid")
    bf, f32, dev = torch.bfloat16, torch.float32, xp.device
    _require(xp, "x", bf, (b, tp, d), dev)
    _require(ln_scale, "ln_scale", f32, (d,), dev)
    _require(ln_bias, "ln_bias", f32, (d,), dev)
    _require(w_qkv, "w_qkv", bf, (d, 3 * d), dev)
    _require(b_qkv, "b_qkv", f32, (3 * d,), dev)
    _require(w_proj, "w_proj", bf, (d, d), dev)
    _require(b_proj, "b_proj", f32, (d,), dev)
    lib, fn = _entry("attention_block")
    out = torch.empty_like(xp)
    scratch = torch.empty((b * tp, d), dtype=bf, device=dev)
    qkv = torch.empty((b * tp, 3 * d), dtype=bf, device=dev)
    err = fn(xp.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
             b_proj.data_ptr(), scratch.data_ptr(), qkv.data_ptr(),
             out.data_ptr(), b, tp, d, num_heads, valid_len, eps,
             float(dh) ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "attention_block", err)
    LAUNCHES["attention_block"] += 1
    return out


def fused_attention_block(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                          b_proj, num_heads: int, *, eps: float = 1e-6):
    """``x [B, T, D]`` -> ``x + proj(attn(LN(x)))``: pads T to a multiple
    of 8, runs :func:`fused_attention_block_padded`, slices back."""
    b, t, d = x.shape
    tp = _round_up(t, 8)
    xp = torch.nn.functional.pad(x, (0, 0, 0, tp - t))
    out = fused_attention_block_padded(
        xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
        valid_len=t, eps=eps)
    return out[:, :t, :]


# --------------------------------------------------------------------------
# MLP block
# --------------------------------------------------------------------------


def fused_mlp_block_plain(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2,
                          *, eps: float = 1e-6):
    """Plain PyTorch version of the MLP-block kernel: LN and the
    tanh-GELU in f32, xn and the GELU output rounded to ``x.dtype``,
    ``x + b2 + fc2`` summed in f32 and rounded once."""
    cdt = x.dtype
    with exact_f32_matmul():
        x32 = x.float()
        xn = _layernorm_f32(x32, ln_scale, ln_bias, eps).to(cdt)
        h = gelu(_mm(xn, w_fc1) + b_fc1.float(), approximate=True).to(cdt)
        return (x32 + b_fc2.float() + _mm(h, w_fc2)).to(cdt)


def fused_mlp_block(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, *,
                    eps: float = 1e-6):
    """``x [B, T, D]`` -> ``x + MLP(LN(x))`` over the flat ``B*T`` rows.

    On the card: bf16 ``x``, ``w_fc1 [D, hidden]`` and
    ``w_fc2 [hidden, D]``; f32 LN and bias vectors; any row count, with
    D and hidden multiples of 8."""
    if x.device.type == "cpu":
        return fused_mlp_block_plain(x, ln_scale, ln_bias, w_fc1, b_fc1,
                                     w_fc2, b_fc2, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, t, d = x.shape
    hidden = w_fc1.shape[-1]
    if d % 8 or hidden % 8:
        raise ValueError(f"the MLP kernel takes D and hidden that are "
                         f"multiples of 8; got D {d}, hidden {hidden}")
    rows = b * t
    bf, f32, dev = torch.bfloat16, torch.float32, x.device
    _require(x, "x", bf, (b, t, d), dev)
    _require(ln_scale, "ln_scale", f32, (d,), dev)
    _require(ln_bias, "ln_bias", f32, (d,), dev)
    _require(w_fc1, "w_fc1", bf, (d, hidden), dev)
    _require(b_fc1, "b_fc1", f32, (hidden,), dev)
    _require(w_fc2, "w_fc2", bf, (hidden, d), dev)
    _require(b_fc2, "b_fc2", f32, (d,), dev)
    lib, fn = _entry("mlp_block")
    out = torch.empty_like(x)
    scratch = torch.empty((rows, d), dtype=bf, device=dev)
    hid = torch.empty((rows, hidden), dtype=bf, device=dev)
    err = fn(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             w_fc1.data_ptr(), b_fc1.data_ptr(), w_fc2.data_ptr(),
             b_fc2.data_ptr(), scratch.data_ptr(), hid.data_ptr(),
             out.data_ptr(), rows, d, hidden, eps,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "mlp_block", err)
    LAUNCHES["mlp_block"] += 1
    return out
