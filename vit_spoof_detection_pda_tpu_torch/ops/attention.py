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
activations and weights (the training kernels also f32) and raises on
anything else.  ``LAUNCHES`` counts the kernel calls (one per wrapper
call on the card, the f32 forms under their own ``*_f32`` names), so a
run can show that its main path went through the kernels.

Training adds two kernels:

- :func:`attention_block_train_padded`: the attention block with the
  backward's residuals as outputs (``qkv``, the head outputs, the LN's
  ``xhat`` and ``inv``).  Kernel: ``csrc/attention_block_train.cu``;
  replaces ``_attn_block_train_kernel`` (JAX ``models/fasttrain.py:70``).
- :func:`attention_qkv_bwd`: ``dqkv`` of the attention core from ``qkv``
  and the head outputs' cotangent.  Kernel: ``csrc/attention_qkv_bwd.cu``;
  replaces ``_attn_qkv_bwd_kernel`` (JAX ``ops/attention.py:199``).
- :func:`attention_qkv_bwd_phased`: the same ``dqkv`` on the TPU's
  opt-in phase-split schedule, selected by :data:`BWD_PHASED`.  Kernel:
  ``csrc/attention_qkv_bwd_phased.cu`` (bf16 and f32); replaces
  ``_attn_qkv_bwd_kernel_phased`` (JAX ``ops/attention.py:259``).
- :func:`mlp_block_train`: the MLP block with the stored-hidden
  backward's residuals (``xhat``, ``inv``, the hidden ``h``), erf or tanh
  GELU.  Kernel: ``csrc/mlp_block_train.cu``; replaces
  ``_mlp_block_train_p_kernel`` (JAX ``models/fasttrain.py:508``).

f32 training (``compute_dtype="float32"``) runs f32 forms in plain f32
FMAs, never TF32: the attention blocks (serving and training) on
``csrc/attention_block_f32.cu``, the attention backward on
``csrc/attention_qkv_bwd_f32.cu`` and the MLP block on the f32 route of
``csrc/mlp_block_train.cu``.

The module path (``models/vit.py::Attention``, eval and the Trainer's
validation) adds one:

- :func:`fused_attention_qkv`: ``softmax(Q K^T / sqrt(dh)) V`` per head
  on the fused projection ``qkv [B, T, 3D]`` -> ``[B, T, D]``, in bf16
  and in f32, differentiable (its backward is :func:`attention_qkv_bwd`,
  bf16 or f32).  Kernel: ``csrc/attention_qkv.cu``; replaces
  ``_attn_qkv_kernel`` (JAX ``ops/attention.py:119``).  The module
  reaches it through :func:`dispatch_attention_qkv`.

The int8 module path (``models/serving.py``) and
``models/vit.py::dot_product_attention`` add one more:

- :func:`fused_attention`: the same core on three tensors ``q, k, v
  [B, T, H, Dh]`` (strided views of one projection allowed), in bf16 and
  in f32, differentiable (the dense recompute backward).  Kernel:
  ``csrc/attention.cu``, sharing kernel 8's core; replaces
  ``_attn_kernel`` (JAX ``ops/attention.py:58``).

The serving kernels (1, 2, 8, 9) are also ``vsd::`` operators (the end
of this module) for frozen programs (``models/artifact.py``).

The block kernels are bound by the tensor cores on the H100, the
backward by its bytes; the source notes in ``csrc/`` give the bounds and
what the first design does about them.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import exact_f32_matmul
from . import _build
from .gelu import gelu

LAUNCHES = _build.LAUNCHES     # one dict for every kernel of the port
_MAX_SMEM = 232448          # dynamic shared memory one H100 block may use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    "attention_block": ("vsd_attention_block",
                        [_P] * 10 + [_I] * 5 + [_F, _F, _P]),
    "mlp_block": ("vsd_mlp_block", [_P] * 10 + [_I] * 3 + [_F, _P]),
    "attention_block_train": ("vsd_attention_block_train",
                              [_P] * 13 + [_I] * 5 + [_F, _F, _P]),
    "attention_qkv_bwd": ("vsd_attention_qkv_bwd",
                          [_P] * 3 + [_I] * 5 + [_F, _P]),
    "attention_qkv": ("vsd_attention_qkv", [_P] * 2 + [_I] * 6 + [_F, _P]),
    "attention": ("vsd_attention", [_P] * 4 + [_I] * 5 + [_LL] * 2 + [_F, _P]),
    "attention_block_f32": ("vsd_attention_block_f32",
                            [_P] * 13 + [_I] * 5 + [_F, _F, _P]),
    "attention_qkv_bwd_f32": ("vsd_attention_qkv_bwd_f32",
                              [_P] * 4 + [_I] * 5 + [_F, _P]),
    "mlp_block_train": ("vsd_mlp_block_train",
                        [_P] * 13 + [_I] * 3 + [_F] + [_I] * 2 + [_P]),
    "attention_qkv_bwd_phased": ("vsd_attention_qkv_bwd_phased",
                                 [_P] * 4 + [_I] * 7 + [_F, _P]),
}
# the f32 kernels' blocks: 8 warps, each on 4 query rows (or keys) at a time
_F32_WARPS, _F32_ROWS = 8, 4


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
    return _build.entry(name, *_SIGNATURES[name])


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


def attention_block_train_padded_plain(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_proj, b_proj, num_heads: int, *,
                                       valid_len: int, eps: float = 1e-6):
    """Plain PyTorch version of the attention-block kernels, rounding where
    the TPU kernels do (to ``xp.dtype``): xn, qkv, the softmax weights
    and the concatenated head outputs; everything else in f32.

    Returns ``(out, qkv, attn, xhat, inv)``: ``out``, ``attn`` and
    ``xhat`` ``[B, Tp, D]`` and ``qkv [B, Tp, 3D]`` in ``xp.dtype``,
    ``inv = rsqrt(var + eps)`` ``[B, Tp, 1]`` f32."""
    b, tp, d = xp.shape
    d = _check_head_geometry(d, num_heads)
    dh = d // num_heads
    cdt = xp.dtype
    scale = float(dh) ** -0.5
    with exact_f32_matmul():
        x = xp.float()
        mu = x.mean(-1, keepdim=True)
        inv = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)
        xh = (x - mu) * inv
        xn = (xh * ln_scale.float() + ln_bias.float()).to(cdt)
        qkv = (_mm(xn, w_qkv) + b_qkv.float()).to(cdt)
        q, k, v = qkv.view(b, tp, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
        w = _softmax_weights(q, k, scale, valid_len)          # [B,H,Tp,Tp]
        heads = _mm(w.to(cdt), v)                              # [B,H,Tp,dh]
        attn = heads.permute(0, 2, 1, 3).reshape(b, tp, d).to(cdt)
        out = (x + _mm(attn, w_proj) + b_proj.float()).to(cdt)
        return out, qkv, attn, xh.to(cdt), inv


def _softmax_weights(q, k, scale: float, valid_len: int):
    """f32 softmax of ``q k^T * scale`` with key columns at or past
    ``valid_len`` at -1e30, as the TPU kernels mask them."""
    logits = _mm(q, k.transpose(-1, -2)) * scale
    keep = torch.arange(logits.shape[-1], device=q.device) < valid_len
    logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    return torch.softmax(logits, dim=-1)


def fused_attention_block_padded_plain(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_proj, b_proj, num_heads: int, *,
                                       valid_len: int, eps: float = 1e-6):
    """Plain PyTorch version of the serving attention-block kernel: the
    first output of :func:`attention_block_train_padded_plain`."""
    return attention_block_train_padded_plain(
        xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
        valid_len=valid_len, eps=eps)[0]


def _check_attention_block_args(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                w_proj, b_proj, num_heads, valid_len):
    """Raise on what the attention-block kernels do not take; returns
    ``(b, tp, d, dh)``.  bf16 or f32 (the stream and the matrices in one
    dtype)."""
    b, tp, d = xp.shape
    d = _check_head_geometry(d, num_heads)
    dh = d // num_heads
    if dh % 16 or dh > 128 or tp % 8 or not 0 <= valid_len <= tp:
        raise ValueError(
            f"the attention kernel takes a head dim that is a multiple of "
            f"16 up to 128, Tp % 8 == 0 and 0 <= valid_len <= Tp; got head "
            f"dim {dh}, Tp {tp}, valid_len {valid_len}")
    cdt = xp.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x is {cdt}; the attention-block kernels take "
                        "bfloat16 or float32")
    smem = _attention_qkv_smem(tp, dh, cdt)                # K and V (+ f32 rows)
    if smem > _MAX_SMEM:
        raise ValueError(f"Tp {tp} at head dim {dh} needs {smem} bytes of "
                         f"shared memory per block; the card has {_MAX_SMEM}")
    if not 0 < b <= 65535 or num_heads > 65535:
        raise ValueError(f"batch {b} / heads {num_heads} outside the grid")
    f32, dev = torch.float32, xp.device
    _require(xp, "x", cdt, (b, tp, d), dev)
    _require(ln_scale, "ln_scale", f32, (d,), dev)
    _require(ln_bias, "ln_bias", f32, (d,), dev)
    _require(w_qkv, "w_qkv", cdt, (d, 3 * d), dev)
    _require(b_qkv, "b_qkv", f32, (3 * d,), dev)
    _require(w_proj, "w_proj", cdt, (d, d), dev)
    _require(b_proj, "b_proj", f32, (d,), dev)
    return b, tp, d, dh


def _attention_block_f32(xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                         num_heads, valid_len, eps, *, train: bool):
    """Launch the f32 attention block (``csrc/attention_block_f32.cu``):
    ``out`` alone (``train=False``, kernel 1's f32 form) or ``(out, qkv,
    attn, xhat, inv)`` (kernel 3's)."""
    b, tp, d, dh = _check_attention_block_args(
        xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
        valid_len)
    lib, fn = _entry("attention_block_f32")
    dev, f32 = xp.device, torch.float32
    out = torch.empty_like(xp)
    xn = torch.empty((b, tp, d), dtype=f32, device=dev)      # scratch
    qkv = torch.empty((b, tp, 3 * d), dtype=f32, device=dev)
    attn = torch.empty((b, tp, d), dtype=f32, device=dev)
    xh = torch.empty((b, tp, d), dtype=f32, device=dev) if train else None
    inv = torch.empty((b, tp, 1), dtype=f32, device=dev) if train else None
    err = fn(xp.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
             b_proj.data_ptr(), xn.data_ptr(), qkv.data_ptr(),
             attn.data_ptr(), xh.data_ptr() if train else None,
             inv.data_ptr() if train else None, out.data_ptr(),
             b, tp, d, num_heads, valid_len, eps, float(dh) ** -0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    name = "attention_block_train_f32" if train else "attention_block_f32"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return (out, qkv, attn, xh, inv) if train else out


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
    16 up to 128.  f32 ``xp`` and matrices run the f32 kernel
    (``LAUNCHES["attention_block_f32"]``; Tp up to 328 at head dim 64)."""
    if torch.compiler.is_exporting():
        return attention_block_op(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                  w_proj, b_proj, num_heads, valid_len, eps)
    if xp.device.type == "cpu":
        return fused_attention_block_padded_plain(
            xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
            valid_len=valid_len, eps=eps)
    return _attention_block_cuda(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                 w_proj, b_proj, num_heads, valid_len, eps)


def _attention_block_cuda(xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                          b_proj, num_heads, valid_len, eps):
    """Kernel 1 (its bf16 or f32 form) on CUDA tensors."""
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    if xp.dtype == torch.float32:
        return _attention_block_f32(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                    w_proj, b_proj, num_heads, valid_len, eps,
                                    train=False)
    b, tp, d, dh = _check_attention_block_args(
        xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
        valid_len)
    lib, fn = _entry("attention_block")
    out = torch.empty_like(xp)
    scratch = torch.empty((b * tp, d), dtype=xp.dtype, device=xp.device)
    qkv = torch.empty((b * tp, 3 * d), dtype=xp.dtype, device=xp.device)
    err = fn(xp.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
             b_proj.data_ptr(), scratch.data_ptr(), qkv.data_ptr(),
             out.data_ptr(), b, tp, d, num_heads, valid_len, eps,
             float(dh) ** -0.5, torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(lib, "attention_block", err)
    LAUNCHES["attention_block"] += 1
    return out


def attention_block_train_padded(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                 w_proj, b_proj, num_heads: int, *,
                                 valid_len: int, eps: float = 1e-6):
    """:func:`fused_attention_block_padded` that also returns the
    backward's residuals: ``(out, qkv, attn, xhat, inv)`` as
    :func:`attention_block_train_padded_plain` describes, all at the Tp
    rows of ``xp``.  Takes what the serving kernel takes; f32 runs the f32
    kernel (``LAUNCHES["attention_block_train_f32"]``)."""
    if xp.device.type == "cpu":
        return attention_block_train_padded_plain(
            xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
            valid_len=valid_len, eps=eps)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    if xp.dtype == torch.float32:
        return _attention_block_f32(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                    w_proj, b_proj, num_heads, valid_len, eps,
                                    train=True)
    b, tp, d, dh = _check_attention_block_args(
        xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
        valid_len)
    lib, fn = _entry("attention_block_train")
    dev, cdt = xp.device, xp.dtype
    out = torch.empty_like(xp)
    xn = torch.empty((b, tp, d), dtype=cdt, device=dev)      # scratch
    qkv = torch.empty((b, tp, 3 * d), dtype=cdt, device=dev)
    attn = torch.empty((b, tp, d), dtype=cdt, device=dev)
    xh = torch.empty((b, tp, d), dtype=cdt, device=dev)
    inv = torch.empty((b, tp, 1), dtype=torch.float32, device=dev)
    err = fn(xp.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
             b_proj.data_ptr(), xn.data_ptr(), qkv.data_ptr(),
             attn.data_ptr(), xh.data_ptr(), inv.data_ptr(), out.data_ptr(),
             b, tp, d, num_heads, valid_len, eps, float(dh) ** -0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "attention_block_train", err)
    LAUNCHES["attention_block_train"] += 1
    return out, qkv, attn, xh, inv


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
# Attention backward
# --------------------------------------------------------------------------


def attention_qkv_bwd_plain(qkv, g, num_heads: int, *, valid_len: int):
    """Plain PyTorch version of the attention-backward kernel: per head,
    the softmax recomputed in f32 from ``qkv``, then
    ``dv = w^T g``, ``dw = g v^T``, ``dl = w (dw - rowsum(dw w))``,
    ``dq = dl k s`` and ``dk = dl^T q s``.  Rounds where the TPU kernel
    does (to ``qkv.dtype``): ``w`` before ``dv``, ``dl`` before ``dq``
    and ``dk``, and the outputs; ``dl`` uses the f32 ``w`` and ``dw``."""
    b, tp, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    cdt = qkv.dtype
    scale = float(dh) ** -0.5
    with exact_f32_matmul():
        q, k, v = qkv.view(b, tp, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
        gh = g.to(cdt).view(b, tp, num_heads, dh).transpose(1, 2)
        w = _softmax_weights(q, k, scale, valid_len)          # [B,H,Tp,Tp]
        dv = _mm(w.to(cdt).transpose(-1, -2), gh)
        dw = _mm(gh, v.transpose(-1, -2))
        dl = (w * (dw - (dw * w).sum(-1, keepdim=True))).to(cdt)
        dq = _mm(dl, k) * scale
        dk = _mm(dl.transpose(-1, -2), q) * scale
        dqkv = torch.stack([dq, dk, dv], dim=2)               # [B,H,3,Tp,dh]
        return dqkv.permute(0, 3, 2, 1, 4).reshape(b, tp, d3).to(cdt)


# Selects the phase-split attention backward (JAX ``BWD_PHASED``,
# ``ops/attention.py:341``): with it set, :func:`attention_qkv_bwd` launches
# kernel 5 (``csrc/attention_qkv_bwd_phased.cu``) instead of kernel 4 on the
# card, bf16 and f32 alike; the CPU runs the plain version either way.  It
# is read on each call, so setting it takes effect at the next backward
# (JAX reads it at trace time, where a jitted step keeps the kernel it was
# traced with).
BWD_PHASED = False
# workspace of one chunk of the phased backward: f32 [chunk * H, Tp, Tp]
# kept within the 50 MB L2 between its four phases (16 items at ViT-B)
_PHASED_WORKSPACE_BYTES = 32_000_000


def attention_qkv_bwd(qkv, g, num_heads: int, *, valid_len: int):
    """``dqkv [B, Tp, 3D]`` of the attention core on the fused projection
    ``qkv [B, Tp, 3D]`` given the head outputs' cotangent
    ``g [B, Tp, D]``, both already padded to Tp rows with ``valid_len``
    real tokens (the counterpart of the JAX ``_backward_qkv(...,
    valid_len=t)``).  ``g`` must be zero on the pad rows; ``dqkv`` then
    is zero there too.

    On the card: bf16 ``qkv`` and ``g``, any B, ``Tp % 8 == 0``, a head
    dim of 16, 32 or 64, and one head's K and V and the ``[Tp, Tp]`` bf16
    weights and their gradient within shared memory (Tp up to 208 at
    head dim 64).  f32 ``qkv`` and ``g`` run the f32 kernel
    (``LAUNCHES["attention_qkv_bwd_f32"]``): any Tp whose head operands
    fit (up to 264 at head dim 64), a head dim that is a multiple of 16
    up to 128."""
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, g, num_heads,
                                       valid_len=valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if BWD_PHASED:
        return attention_qkv_bwd_phased(qkv, g, num_heads,
                                        valid_len=valid_len)
    if qkv.dtype == torch.float32:
        return _attention_qkv_bwd_f32(qkv, g, num_heads, valid_len)
    b, tp, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    if dh not in (16, 32, 64) or tp % 8 or not 0 < valid_len <= tp:
        raise ValueError(
            f"the attention backward takes a head dim of 16, 32 or 64, "
            f"Tp % 8 == 0 and 0 < valid_len <= Tp; got head dim {dh}, "
            f"Tp {tp}, valid_len {valid_len}")
    tk = _round_up(tp, 16)     # K, V (later Q, G) and the bf16 w, dl tiles
    smem = 2 * (2 * tk * dh + 2 * tk * tk)
    if smem > _MAX_SMEM:
        raise ValueError(f"Tp {tp} at head dim {dh} needs {smem} bytes of "
                         f"shared memory per block; the card has {_MAX_SMEM}")
    if not 0 < b <= 65535 or num_heads > 65535:
        raise ValueError(f"batch {b} / heads {num_heads} outside the grid")
    bf, dev = torch.bfloat16, qkv.device
    _require(qkv, "qkv", bf, (b, tp, d3), dev)
    _require(g, "g", bf, (b, tp, d), dev)
    lib, fn = _entry("attention_qkv_bwd")
    dqkv = torch.empty_like(qkv)
    err = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), b, tp, d,
             num_heads, valid_len, float(dh) ** -0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "attention_qkv_bwd", err)
    LAUNCHES["attention_qkv_bwd"] += 1
    return dqkv


def phased_chunk(batch: int, num_heads: int, tp: int) -> int:
    """Items a chunk of the phased backward: as many as keep its f32
    workspace ``[chunk * H, Tp, Tp]`` within 32 MB (16 at ViT-B)."""
    per_item = num_heads * tp * tp * 4
    return max(1, min(batch, _PHASED_WORKSPACE_BYTES // per_item))


def attention_qkv_bwd_phased(qkv, g, num_heads: int, *, valid_len: int):
    """:func:`attention_qkv_bwd` on the phase-split schedule of the TPU
    kernel ``_attn_qkv_bwd_kernel_phased`` (JAX ``ops/attention.py:259``):
    the same function, the same rounding points.  On the card: bf16 or f32
    ``qkv`` and ``g`` (``LAUNCHES["attention_qkv_bwd_phased"]`` or
    ``..._phased_f32``), a head dim of 16, 32, 64 or 128, any Tp up to 908;
    the items run in chunks of :func:`phased_chunk` over an f32 workspace,
    four launches a chunk on the current stream.  A CPU tensor runs
    :func:`attention_qkv_bwd_plain`, the plain version of both kernels."""
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, g, num_heads,
                                       valid_len=valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    b, tp, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    if dh not in (16, 32, 64, 128) or not 0 < valid_len <= tp:
        raise ValueError(
            f"the phased attention backward takes a head dim of 16, 32, 64 "
            f"or 128 and 0 < valid_len <= Tp; got head dim {dh}, Tp {tp}, "
            f"valid_len {valid_len}")
    if 4 * 16 * tp * 4 > _MAX_SMEM:
        raise ValueError(f"Tp {tp} needs {4 * 16 * tp * 4} bytes of shared "
                         f"memory per block; the card has {_MAX_SMEM}")
    if num_heads > 65535:
        raise ValueError(f"heads {num_heads} outside the grid")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv is {qkv.dtype}; the kernel takes bf16 or f32")
    dt, dev = qkv.dtype, qkv.device
    _require(qkv, "qkv", dt, (b, tp, d3), dev)
    _require(g, "g", dt, (b, tp, d), dev)
    chunk = phased_chunk(b, num_heads, tp)
    work = torch.empty((chunk * num_heads, tp, tp), dtype=torch.float32,
                       device=dev)
    lib, fn = _entry("attention_qkv_bwd_phased")
    dqkv = torch.empty_like(qkv)
    f32 = dt == torch.float32
    err = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), work.data_ptr(),
             chunk, int(f32), b, tp, d, num_heads, valid_len,
             float(dh) ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "attention_qkv_bwd_phased", err)
    LAUNCHES["attention_qkv_bwd_phased" + ("_f32" if f32 else "")] += 1
    return dqkv


def _attention_qkv_bwd_f32_smem(tp: int, dh: int) -> int:
    """Shared memory of each launch of ``csrc/attention_qkv_bwd_f32.cu``:
    two ``[Tp][dh + 4]`` head tiles, the rows' stats ``[Tp][4]``, and per
    warp two ``[4][dh]`` rows and two ``[Tp][4]`` columns."""
    return 4 * (2 * tp * (dh + 4) + 4 * tp
                + _F32_WARPS * (2 * _F32_ROWS * dh + 8 * tp))


def _attention_qkv_bwd_f32(qkv, g, num_heads: int, valid_len: int):
    """Launch the f32 attention backward on CUDA ``qkv`` and ``g``."""
    b, tp, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    if dh % 16 or dh > 128 or not 0 < valid_len <= tp:
        raise ValueError(
            f"the f32 attention backward takes a head dim that is a multiple "
            f"of 16 up to 128 and 0 < valid_len <= Tp; got head dim {dh}, "
            f"Tp {tp}, valid_len {valid_len}")
    smem = _attention_qkv_bwd_f32_smem(tp, dh)
    if smem > _MAX_SMEM:
        raise ValueError(f"Tp {tp} at head dim {dh} needs {smem} bytes of "
                         f"shared memory per block; the card has {_MAX_SMEM}")
    if not 0 < b <= 65535 or num_heads > 65535:
        raise ValueError(f"batch {b} / heads {num_heads} outside the grid")
    f32, dev = torch.float32, qkv.device
    _require(qkv, "qkv", f32, (b, tp, d3), dev)
    _require(g, "g", f32, (b, tp, d), dev)
    lib, fn = _entry("attention_qkv_bwd_f32")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((b, num_heads, tp, 4), dtype=f32, device=dev)
    err = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
             b, tp, d, num_heads, valid_len, float(dh) ** -0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "attention_qkv_bwd_f32", err)
    LAUNCHES["attention_qkv_bwd_f32"] += 1
    return dqkv


# --------------------------------------------------------------------------
# Attention core on the fused projection (the module path)
# --------------------------------------------------------------------------

def fused_attention_qkv_plain(qkv, num_heads: int):
    """Plain PyTorch version of kernel 8 (JAX ``_attn_qkv_kernel``): per
    head f32 logits ``q k^T * dh^-0.5`` (exact f32 products of the input
    values), the f32 softmax, the weights rounded to ``qkv.dtype`` before
    ``@ v`` with f32 sums, and the output rounded once.  Every key is
    real, so no column is masked: the TPU kernel's pad columns at -1e30
    add exactly 0."""
    b, t, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    cdt = qkv.dtype
    with exact_f32_matmul():
        q, k, v = qkv.reshape(b, t, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
        w = _softmax_weights(q, k, float(dh) ** -0.5, t)      # [B,H,T,T]
        heads = _mm(w.to(cdt), v)                              # [B,H,T,dh]
        return heads.permute(0, 2, 1, 3).reshape(b, t, d).to(cdt)


def _attention_qkv_smem(t: int, dh: int, dtype) -> int:
    """Shared memory of one block of ``csrc/attention_qkv.cu``: bf16, one
    head's K and V rows padded to 16 (``attention_core.cuh``); f32, K and
    V ``[T][dh + 4]`` plus each warp's 4 query rows and their ``[T][4]``
    weights."""
    if dtype == torch.bfloat16:
        return 2 * _round_up(t, 16) * (dh + 8) * 2
    return 4 * (2 * t * (dh + 4) + _F32_WARPS * _F32_ROWS * (dh + t))


def _attention_qkv_kernel(qkv, num_heads: int):
    """Launch kernel 8 on a CUDA ``qkv [B, T, 3D]``; raises on what it does
    not take."""
    b, t, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv is {qkv.dtype}; kernel 8 takes bfloat16 or "
                        "float32")
    # a head dim that is a multiple of 16 also keeps every qkv row (3D
    # values) and head slice 16-byte aligned for the kernels' 16-byte
    # loads, given a 16-byte aligned base (_require)
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"kernel 8 takes a head dim that is a multiple of "
                         f"16 from 16 to 128; got {dh}")
    smem = _attention_qkv_smem(t, dh, qkv.dtype)
    if smem > _MAX_SMEM:
        raise ValueError(f"T {t} at head dim {dh} needs {smem} bytes of "
                         f"shared memory per block; the card has {_MAX_SMEM}")
    if not 0 < b <= 65535 or num_heads > 65535 or t < 1:
        raise ValueError(f"batch {b} / heads {num_heads} / T {t} outside "
                         "the grid")
    _require(qkv, "qkv", qkv.dtype, (b, t, d3), qkv.device)
    lib, fn = _entry("attention_qkv")
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    err = fn(qkv.data_ptr(), out.data_ptr(),
             0 if qkv.dtype == torch.bfloat16 else 1, b, t, d, num_heads, t,
             float(dh) ** -0.5, torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, "attention_qkv", err)
    LAUNCHES["attention_qkv"] += 1
    return out


def _attention_qkv_backward(qkv, g, num_heads: int):
    """JAX ``_qkv_bwd``: ``dqkv`` of the attention core.  On the card at
    bf16 the stream is zero-padded to a multiple of 8 rows for kernel 4
    and sliced back; kernel 4's f32 form and the CPU's plain version run
    unpadded."""
    b, t, _ = qkv.shape
    g = g.to(qkv.dtype).contiguous()
    if qkv.device.type == "cpu" or qkv.dtype == torch.float32:
        return attention_qkv_bwd(qkv, g, num_heads, valid_len=t)
    tp = _round_up(t, 8)
    pad = (0, 0, 0, tp - t)
    dqkv = attention_qkv_bwd(
        torch.nn.functional.pad(qkv, pad).contiguous(),
        torch.nn.functional.pad(g, pad).contiguous(), num_heads, valid_len=t)
    return dqkv[:, :t]


class _AttentionQKV(torch.autograd.Function):
    """Kernel 8 forward, kernel 4 backward (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv)
        if qkv.device.type == "cpu":
            return fused_attention_qkv_plain(qkv, num_heads)
        if qkv.device.type != "cuda":
            raise ValueError(f"no kernel for device {qkv.device}")
        return _attention_qkv_kernel(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return _attention_qkv_backward(qkv, g, ctx.num_heads), None


def fused_attention_qkv(qkv, num_heads: int):
    """``qkv [B, T, 3D]`` (q | k | v, heads contiguous inside each) ->
    the concatenated head outputs ``[B, T, D]`` in ``qkv.dtype``
    (counterpart of the JAX ``fused_attention_qkv`` :194).

    A CPU tensor runs :func:`fused_attention_qkv_plain`; a CUDA one runs
    kernel 8 on bf16 or f32, any B and T, a head dim that is a multiple
    of 16 from 16 to 128 and one head's K and V within shared memory (T
    up to 333 at head dim 64 in f32).  Differentiable: the backward is
    the attention-backward kernel (bf16 or f32) on the card and its plain
    version on the CPU."""
    if not qkv.is_contiguous():
        qkv = qkv.contiguous()
    if torch.compiler.is_exporting():
        return attention_qkv_op(qkv, num_heads)
    return _AttentionQKV.apply(qkv, num_heads)


def dispatch_attention_qkv(qkv, num_heads: int, *, mesh=None):
    """The attention core of ``models/vit.py::Attention`` (JAX
    ``dispatch_attention_qkv`` :663, its single-device step): a CUDA
    tensor goes to kernel 8, a CPU tensor to its plain version.  The
    mesh, sequence-, head-parallel and ``manual_attention`` branches are
    not ported; passing a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "attention under a device mesh (data, sequence or head "
            "parallel) is not ported: ROADMAP Queue 1 item 9 (slice 6, "
            "parallelism)")
    return fused_attention_qkv(qkv, num_heads)


# --------------------------------------------------------------------------
# Generic q/k/v attention (kernel 9: the int8 module path and
# models/vit.py::dot_product_attention)
# --------------------------------------------------------------------------


def fused_attention_plain(q, k, v):
    """Plain PyTorch version of kernel 9 (JAX ``_attn_kernel`` :58, whose
    reference is ``_dense_reference`` :1065): ``q, k, v [B, T, H, Dh]``
    -> ``[B, T, H, Dh]`` in ``q.dtype``.  Per head the f32 logits
    ``q k^T * Dh^-0.5`` (exact f32 products of the input values), the f32
    softmax, the weights rounded to ``v.dtype``, ``@ v`` with f32 sums,
    the output rounded once.  The TPU kernel pads T to a multiple of 8
    and masks the pad keys at -1e30, which add exactly 0; no key is
    masked here."""
    b, t, h, dh = q.shape
    with exact_f32_matmul():
        w = _softmax_weights(q.transpose(1, 2), k.transpose(1, 2),
                             float(dh) ** -0.5, t)           # [B,H,T,T]
        out = _mm(w.to(v.dtype), v.transpose(1, 2))           # [B,H,T,Dh]
        return out.transpose(1, 2).to(q.dtype).contiguous()


def _attention_strides(q, k, v):
    """``(ld, bs)``: the row and batch strides (elements) that q, k and v
    share with heads and head columns contiguous, or None when they do
    not (the wrapper then copies them)."""
    b, t, h, dh = q.shape
    align = 8 if q.dtype == torch.bfloat16 else 4
    st = q.stride()
    if st[3] != 1 or st[2] != dh or st[1] % align:
        return None
    if any(x.stride() != st or x.data_ptr() % 16 for x in (q, k, v)):
        return None
    return st[1], (st[0] if b > 1 else t * st[1])


def _attention_kernel(q, k, v):
    """Launch kernel 9 on CUDA ``q, k, v [B, T, H, Dh]`` of one dtype;
    raises on what it does not take."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q is {q.dtype}; kernel 9 takes bfloat16 or "
                        "float32")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must share one shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, t, h, dh = q.shape
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"kernel 9 takes a head dim that is a multiple of "
                         f"16 from 16 to 128; got {dh}")
    smem = _attention_qkv_smem(t, dh, q.dtype)           # kernel 8's core
    if smem > _MAX_SMEM:
        raise ValueError(f"T {t} at head dim {dh} needs {smem} bytes of "
                         f"shared memory per block; the card has {_MAX_SMEM}")
    if not 0 < b <= 65535 or not 0 < h <= 65535 or t < 1:
        raise ValueError(f"batch {b} / heads {h} / T {t} outside the grid")
    strides = _attention_strides(q, k, v)
    if strides is None:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        strides = _attention_strides(q, k, v)
    lib, fn = _entry("attention")
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if q.dtype == torch.bfloat16 else 1, b, t, h, dh, *strides,
             float(dh) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    name = "attention" if q.dtype == torch.bfloat16 else "attention_f32"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return out


def fused_attention_backward(q, k, v, g):
    """JAX ``_bwd`` (:1085): the dense recompute of ``(dq, dk, dv)`` in
    f32, each rounded to its input's dtype.  Plain PyTorch on both
    devices: the TPU package's backward is XLA, not a kernel."""
    dh = q.shape[-1]
    scale = float(dh) ** -0.5
    with exact_f32_matmul():
        q32, k32, v32 = q.float(), k.float(), v.float()
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale,
                          dim=-1)
        g32 = g.float()
        dv = torch.einsum("bhqk,bqhd->bkhd", w, g32)
        dw = torch.einsum("bqhd,bkhd->bhqk", g32, v32)
        dlogits = w * (dw - (dw * w).sum(-1, keepdim=True))
        dq = torch.einsum("bhqk,bkhd->bqhd", dlogits, k32) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", dlogits, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """Kernel 9 forward, the dense recompute backward (the JAX
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v)
        if q.device.type != "cuda":
            raise ValueError(f"no kernel for device {q.device}")
        return _attention_kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return fused_attention_backward(*ctx.saved_tensors, g)


def fused_attention(q, k, v):
    """``q, k, v [B, T, H, Dh]`` -> ``[B, T, H, Dh]`` in ``q.dtype``
    (counterpart of the JAX ``fused_attention`` :1076).

    A CPU tensor runs :func:`fused_attention_plain`; a CUDA one runs
    kernel 9 (``csrc/attention.cu``; ``LAUNCHES["attention"]``, the f32
    form ``"attention_f32"``) on bf16 or f32, any B and T, a head
    dim that is a multiple of 16 from 16 to 128 and one head's K and V
    within shared memory.  q, k and v may be strided views (the int8
    path passes the three slices of one ``[B, T, 3, H, Dh]`` projection)
    as long as they share strides with heads and head columns contiguous;
    otherwise they are copied.  Differentiable: the backward is
    :func:`fused_attention_backward`."""
    if torch.compiler.is_exporting():
        return attention_op(q, k, v)
    return _Attention.apply(q, k, v)


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
    if torch.compiler.is_exporting():
        return mlp_block_op(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2,
                            eps)
    if x.device.type == "cpu":
        return fused_mlp_block_plain(x, ln_scale, ln_bias, w_fc1, b_fc1,
                                     w_fc2, b_fc2, eps=eps)
    return _mlp_block_cuda(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2,
                           eps)


def _mlp_block_cuda(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, eps):
    """Kernel 2 on CUDA tensors."""
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


# --------------------------------------------------------------------------
# MLP block for training (the stored-hidden residuals)
# --------------------------------------------------------------------------


def mlp_block_train_plain(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2,
                          *, approximate: bool, eps: float = 1e-6):
    """Plain PyTorch version of kernel 7 over the flat rows ``x [rows,
    D]``: ``(y, xhat, inv, h)`` with the TPU kernel's rounding points (to
    ``x.dtype``): xn, xhat, the hidden ``h = xn @ W1 + b1`` before the GELU
    and the GELU output (f32 math on the rounded ``h``); ``y = (x + a @ W2)
    + b2`` summed in f32 and rounded once; ``inv [rows, 1]`` f32."""
    cdt = x.dtype
    with exact_f32_matmul():
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        inv = torch.rsqrt(((x32 - mu) ** 2).mean(-1, keepdim=True) + eps)
        xh = (x32 - mu) * inv
        xn = (xh * ln_scale.float() + ln_bias.float()).to(cdt)
        h = (_mm(xn, w_fc1) + b_fc1.float()).to(cdt)
        a = torch.nn.functional.gelu(
            h.float(), approximate="tanh" if approximate else "none").to(cdt)
        y = ((x32 + _mm(a, w_fc2)) + b_fc2.float()).to(cdt)
        return y, xh.to(cdt), inv, h


def mlp_block_train(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, *,
                    approximate: bool, eps: float = 1e-6):
    """``x [rows, D]`` -> ``(y [rows, D], xhat [rows, D], inv [rows, 1],
    h [rows, hidden])`` of ``y = x + fc2(gelu(fc1(LN(x))))``, the
    residuals of the stored-hidden backward (the counterpart of JAX
    ``_mlp_fwd_pallas``, unpadded); erf GELU, or tanh with
    ``approximate``.

    On the card: ``x``, ``w_fc1 [D, hidden]`` and ``w_fc2 [hidden, D]``
    all bf16 (``LAUNCHES["mlp_block_train"]``) or all f32
    (``"mlp_block_train_f32"``); f32 LN and bias vectors; any row count,
    D and hidden multiples of 8."""
    if x.device.type == "cpu":
        return mlp_block_train_plain(x, ln_scale, ln_bias, w_fc1, b_fc1,
                                     w_fc2, b_fc2, approximate=approximate,
                                     eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    rows, d = x.shape
    hidden = w_fc1.shape[-1]
    if d % 8 or hidden % 8:
        raise ValueError(f"the MLP kernel takes D and hidden that are "
                         f"multiples of 8; got D {d}, hidden {hidden}")
    cdt = x.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x is {cdt}; kernel 7 takes bfloat16 or float32")
    f32, dev = torch.float32, x.device
    _require(x, "x", cdt, (rows, d), dev)
    _require(ln_scale, "ln_scale", f32, (d,), dev)
    _require(ln_bias, "ln_bias", f32, (d,), dev)
    _require(w_fc1, "w_fc1", cdt, (d, hidden), dev)
    _require(b_fc1, "b_fc1", f32, (hidden,), dev)
    _require(w_fc2, "w_fc2", cdt, (hidden, d), dev)
    _require(b_fc2, "b_fc2", f32, (d,), dev)
    lib, fn = _entry("mlp_block_train")
    y, xh, xn = (torch.empty_like(x) for _ in range(3))
    h = torch.empty((rows, hidden), dtype=cdt, device=dev)
    act = torch.empty((rows, hidden), dtype=cdt, device=dev)     # scratch
    inv = torch.empty((rows, 1), dtype=f32, device=dev)
    err = fn(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             w_fc1.data_ptr(), b_fc1.data_ptr(), w_fc2.data_ptr(),
             b_fc2.data_ptr(), xn.data_ptr(), act.data_ptr(), h.data_ptr(),
             xh.data_ptr(), inv.data_ptr(), y.data_ptr(), rows, d, hidden,
             eps, int(not approximate), int(cdt == f32),
             torch.cuda.current_stream(dev).cuda_stream)
    name = "mlp_block_train_f32" if cdt == f32 else "mlp_block_train"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return y, xh, inv, h


# --------------------------------------------------------------------------
# The serving kernels as PyTorch operators (vsd::)
# --------------------------------------------------------------------------
# A frozen serving program (models/artifact.py, torch.export) cannot trace
# the ctypes launches, so each serving kernel is also an operator: its CPU
# implementation is the plain version, its CUDA one the function that
# launches the kernel, and a fake one gives the output's shape for the
# trace.  The wrappers above call the operator while a program is being
# exported (torch.compiler.is_exporting()) and the same two functions
# directly otherwise, so the frozen and the live paths cannot differ.
_T = torch.Tensor


@torch.library.custom_op("vsd::attention_block", mutates_args=(),
                         device_types="cpu")
def attention_block_op(xp: _T, ln_scale: _T, ln_bias: _T, w_qkv: _T,
                       b_qkv: _T, w_proj: _T, b_proj: _T, num_heads: int,
                       valid_len: int, eps: float) -> _T:
    return fused_attention_block_padded_plain(
        xp, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads,
        valid_len=valid_len, eps=eps)


attention_block_op.register_kernel("cuda")(_attention_block_cuda)


@attention_block_op.register_fake
def _(xp, *args):
    return torch.empty_like(xp)


@torch.library.custom_op("vsd::mlp_block", mutates_args=(),
                         device_types="cpu")
def mlp_block_op(x: _T, ln_scale: _T, ln_bias: _T, w_fc1: _T, b_fc1: _T,
                 w_fc2: _T, b_fc2: _T, eps: float) -> _T:
    return fused_mlp_block_plain(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2,
                                 b_fc2, eps=eps)


mlp_block_op.register_kernel("cuda")(_mlp_block_cuda)


@mlp_block_op.register_fake
def _(x, *args):
    return torch.empty_like(x)


@torch.library.custom_op("vsd::attention_qkv", mutates_args=(),
                         device_types="cpu")
def attention_qkv_op(qkv: _T, num_heads: int) -> _T:
    return fused_attention_qkv_plain(qkv, num_heads)


attention_qkv_op.register_kernel("cuda")(_attention_qkv_kernel)


@attention_qkv_op.register_fake
def _(qkv, num_heads):
    b, t, d3 = qkv.shape
    return qkv.new_empty((b, t, d3 // 3))


@torch.library.custom_op("vsd::attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q: _T, k: _T, v: _T) -> _T:
    return fused_attention_plain(q, k, v)


attention_op.register_kernel("cuda")(_attention_kernel)


@attention_op.register_fake
def _(q, k, v):
    return q.new_empty(q.shape)
