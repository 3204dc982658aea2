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
  and the head outputs' cotangent.  Kernel: ``csrc/attention_qkv_bwd.cu``
  on the one-launch on-chip backward ``csrc/attention_bwd_onchip.cuh``
  (:func:`onchip_bwd_plan`); replaces ``_attn_qkv_bwd_kernel`` (JAX
  ``ops/attention.py:199``).
- :func:`attention_qkv_bwd_phased`: the same ``dqkv`` on the TPU's
  opt-in phase-split schedule, selected by :data:`BWD_PHASED`.  Kernel:
  ``csrc/attention_qkv_bwd_phased.cu``, the same on-chip core under its
  own entry point and launch count; replaces
  ``_attn_qkv_bwd_kernel_phased`` (JAX ``ops/attention.py:259``).  Every
  shape past the core goes, for both, to the key-tiled backward
  ``csrc/attention_bwd_tiled.cu`` (:func:`phased_plan`).
- :func:`mlp_block_train`: the MLP block with the stored-hidden
  backward's residuals (``xhat``, ``inv``, the hidden ``h``), erf or tanh
  GELU.  Kernel: ``csrc/mlp_block_train.cu``; replaces
  ``_mlp_block_train_p_kernel`` (JAX ``models/fasttrain.py:508``).

f32 training (``compute_dtype="float32"``) runs f32 forms in plain f32
FMAs, never TF32: the attention blocks (serving and training) on
``csrc/attention_block_f32.cu``, the attention backward on the f32 form of
the on-chip core and the MLP block on the f32 route of
``csrc/mlp_block_train.cu``.

The module path (``models/vit.py::Attention``, eval and the Trainer's
validation) adds one:

- :func:`fused_attention_qkv`: ``softmax(Q K^T / sqrt(dh)) V`` per head
  on the fused projection ``qkv [B, T, 3D]`` -> ``[B, T, D]``, in bf16
  and in f32, differentiable (its backward is :func:`attention_qkv_bwd`,
  bf16 or f32).  Kernel: ``csrc/attention_qkv.cu`` on the routes of
  ``csrc/attention_self.cuh`` (kernel 12's one-pass core up to 208 keys,
  :func:`module_attention_plan`); replaces ``_attn_qkv_kernel`` (JAX
  ``ops/attention.py:119``).  The module reaches it through
  :func:`dispatch_attention_qkv`.

The int8 module path (``models/serving.py``) and
``models/vit.py::dot_product_attention`` add one more:

- :func:`fused_attention`: the same core on three tensors ``q, k, v
  [B, T, H, Dh]`` (strided views of one projection allowed), in bf16 and
  in f32, differentiable (the dense recompute backward).  Kernel:
  ``csrc/attention.cu``, sharing kernel 8's core; replaces
  ``_attn_kernel`` (JAX ``ops/attention.py:58``).

Sequence parallelism (a ``seq`` mesh axis, :func:`attention_sharding`)
adds two:

- :func:`fused_attention_qkv_cp`: the local query block ``q [B, Tq, D]``
  against the gathered keys ``kv [B, Tk, 2D]``, bf16 and f32,
  differentiable.  Kernel: ``csrc/attention_cp.cu`` (its own core,
  ``attention_cp_core.cuh``, :func:`cp_plan`); replaces ``_attn_cp_kernel``
  (JAX ``ops/attention.py:836``).
- :func:`attention_cp_bwd`: its backward, ``dq`` and this rank's partial
  ``dkv``.  Kernel: ``csrc/attention_cp_bwd.cu`` (kernel 4's on-chip core
  on the ``[Tq, Tk]`` rectangle; past it the key-tiled backward's
  rectangular instance, :func:`cp_bwd_plan`); replaces
  ``_attn_cp_bwd_kernel`` (JAX :865).

Past what one block holds, each attention kernel takes a key-tiled route
chosen by shape before any launch (:func:`attention_qkv_bwd_plan`,
:func:`phased_plan`, :func:`cp_plan`, :func:`cp_bwd_plan`,
:func:`module_attention_plan`): the key-tiled backward
``csrc/attention_bwd_tiled.cu`` (kernels 4, 5 and 13), the key-tiled f32
core of ``csrc/attention_f32.cuh`` (kernels 1 / 3, 8 and 9 at f32),
kernel 12's key tiles, which also carry kernels 1 / 3, 8 and 9 at bf16
past one head's K and V (the blocks' attention stage takes the routes of
kernels 8 and 9, :func:`module_attention_plan`).  So the card takes every
shape the JAX functions take.

The blocks (kernels 1, 2, 3 and 7) run their products on the GEMM cores
of ``ops/gemm.py`` (bf16: ``csrc/gemm_core.cuh``, TMA-fed, warp-specialised
and persistent; f32: ``csrc/f32_common.cuh``).

The serving kernels (1, 2, 8, 9) are also ``vsd::`` operators (the end
of this module) for frozen programs (``models/artifact.py``).

The block kernels are bound by the tensor cores on the H100, the
backward by its bytes at 224 px and by its products past that; the
source notes in ``csrc/`` give the bounds and what each design does about
them.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..device import exact_f32_matmul
from . import _build
from . import gemm as _gemm
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
    "mlp_block_plan": ("vsd_mlp_block_plan",
                       [_I] * 4 + [ctypes.POINTER(_I), _I]),
    "attention_block_train": ("vsd_attention_block_train",
                              [_P] * 13 + [_I] * 5 + [_F, _F, _P]),
    "attention_qkv_bwd": ("vsd_attention_qkv_bwd",
                          [_P] * 3 + [_I] * 6 + [_F, _P]),
    "attention_qkv": ("vsd_attention_qkv", [_P] * 2 + [_I] * 6 + [_F, _P]),
    "attention": ("vsd_attention", [_P] * 4 + [_I] * 5 + [_LL] * 2 + [_F, _P]),
    "attention_block_f32": ("vsd_attention_block_f32",
                            [_P] * 13 + [_I] * 5 + [_F, _F, _P]),
    "mlp_block_train": ("vsd_mlp_block_train",
                        [_P] * 13 + [_I] * 3 + [_F] + [_I] * 2 + [_P]),
    "attention_qkv_bwd_phased": ("vsd_attention_qkv_bwd_phased",
                                 [_P] * 3 + [_I] * 6 + [_F, _P]),
    "attention_bwd_tiled": ("vsd_attention_bwd_tiled",
                            [_P] * 8 + [_I] * 9 + [_LL] * 3 + [_I, _F, _P]),
    "attention_cp": ("vsd_attention_cp", [_P] * 3 + [_I] * 7 + [_F, _P]),
    "attention_cp_bwd": ("vsd_attention_cp_bwd",
                         [_P] * 5 + [_I] * 7 + [_F, _P]),
    "onchip_bwd_config": ("vsd_onchip_bwd_config",
                          [_I] * 4 + [ctypes.POINTER(_I)] * 2
                          + [ctypes.POINTER(_LL)]),
}
# entry points built into another kernel's library: kernels 4, 5 and 13
# launch one core, built once (csrc/attention_bwd_onchip.cu)
_LIBRARY = {name: "attention_bwd_onchip" for name in (
    "attention_qkv_bwd", "attention_qkv_bwd_phased", "attention_cp_bwd",
    "onchip_bwd_config")}
_LIBRARY["mlp_block_plan"] = "mlp_block"
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
    return _build.entry(_LIBRARY.get(name, name), *_SIGNATURES[name])


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
    tiled = module_attention_plan(tp, dh, torch.float32)["form"] == "key_tiled"
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
    name = ("attention_block_train_f32" if train
            else "attention_block_f32") + ("_tiled" if tiled else "")
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
    f32 ``ln_scale``, ``ln_bias``, ``b_qkv`` and ``b_proj``; any B, any
    ``Tp % 8 == 0`` and a head dim that is a multiple of 16 up to 128.
    The attention stage takes the routes of kernels 8 and 9
    (:func:`module_attention_plan`): kernel 12's one pass to 208 keys, its two
    passes with K and V whole to Tp 800 at head dim 64, then its key
    tiles (``LAUNCHES["attention_block_tiled"]``).  f32 ``xp`` and
    matrices run the f32 kernel (``LAUNCHES["attention_block_f32"]``; one
    pass to 208 keys, the whole f32 core to Tp 333 at head dim 64, then
    its key tiles, ``"attention_block_f32_tiled"``).  Each call launches
    the GEMM core twice (``ops/gemm.py::core_launches``)."""
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
    tiled = module_attention_plan(tp, dh, xp.dtype)["form"] == "key_tiled"
    lib, fn = _entry("attention_block")
    out = torch.empty_like(xp)
    scratch = torch.empty((b * tp, d), dtype=xp.dtype, device=xp.device)
    qkv = torch.empty((b * tp, 3 * d), dtype=xp.dtype, device=xp.device)
    err = fn(xp.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
             w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
             b_proj.data_ptr(), scratch.data_ptr(), qkv.data_ptr(),
             out.data_ptr(), b, tp, d, num_heads, valid_len, eps,
             float(dh) ** -0.5, torch.cuda.current_stream(xp.device).cuda_stream)
    name = "attention_block_tiled" if tiled else "attention_block"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return out


def attention_block_train_padded(xp, ln_scale, ln_bias, w_qkv, b_qkv,
                                 w_proj, b_proj, num_heads: int, *,
                                 valid_len: int, eps: float = 1e-6):
    """:func:`fused_attention_block_padded` that also returns the
    backward's residuals: ``(out, qkv, attn, xhat, inv)`` as
    :func:`attention_block_train_padded_plain` describes, all at the Tp
    rows of ``xp``.  Takes what the serving kernel takes
    (``LAUNCHES["attention_block_train"]``, ``"attention_block_train_tiled"``
    on the key-tiled route); f32 runs the f32 kernel
    (``"attention_block_train_f32"``, or ``"attention_block_train_f32_tiled"``
    on the key-tiled core)."""
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
    tiled = module_attention_plan(tp, dh, xp.dtype)["form"] == "key_tiled"
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
    name = "attention_block_train" + ("_tiled" if tiled else "")
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
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
# traced with).  Both kernels launch the same on-chip core; the flag picks
# the entry point and the launch count.
BWD_PHASED = False
# the on-chip backward (csrc/attention_bwd_onchip.cuh): bf16 warps a block
# and the keys (Tk rounded up to 16) a warp holds, its instances; f32
# threads a block, query rows a chunk, keys of the smaller instance and the
# largest Tk by head dim
_ON_WARPS, _ON_MAX_KEYS, _ON_KEYS = 7, 208, (64, 128, 208)
_ON_F32_THREADS, _ON_F32_ROWS, _ON_F32_KEYS = 256, 16, 256
_ON_F32_MAX_KEYS = {16: 576, 32: 448, 64: 320}
# the key-tiled backward (csrc/attention_bwd_tiled.cu): warps a block (16
# query rows or keys each) and the rows of a staged tile, bf16 and f32
_KT_WARPS, _KT_TILE = 4, 64
_KT_F32_WARPS, _KT_F32_TILE = 8, 32
_F32_WSTRIDE = 20              # a row of the f32 forms' per-warp weight chunk


def _check_head_dim(dh: int, what: str):
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"{what} takes a head dim that is a multiple of 16 "
                         f"from 16 to 128; got {dh}")


def _check_grid(batch: int, num_heads: int):
    if not 0 < batch <= 65535 or not 0 < num_heads <= 65535:
        raise ValueError(f"batch {batch} / heads {num_heads} outside the grid")


def onchip_bwd_plan(tq: int, tk: int, dh: int, dtype):
    """The one-launch on-chip backward (``csrc/attention_bwd_onchip.cuh``)
    that kernels 4, 5 and 13 launch, for Tq query rows against Tk keys at
    head dim ``dh``: ``{"keys", "warps", "smem"}`` (the instance, the
    warps of a block and its dynamic shared memory), or None where it does
    not hold the head.  Head dims 16, 32 and 64; bf16 Tk rounded up to 16
    at most 208 (the keys a warp holds in registers) with K, V and the
    ``[Tq, Tk]`` bf16 w and dl tiles within shared memory (Q and G in tiles
    of their own where room is left, else over K and V); f32 Tk up to 576,
    448 or 320 at head dims 16, 32 and 64 with K and V within shared
    memory, any Tq.  The fields mirror the C launcher's own choice
    (``onchip_config``); :func:`onchip_bwd_launch_config` reads that
    choice from the library, and the card tests hold this plan to it."""
    if dh not in (16, 32, 64):
        return None
    if dtype == torch.bfloat16:
        nq, nk = _round_up(tq, 16), _round_up(tk, 16)
        smem = 2 * (2 * nk * dh + 2 * nq * nk + 2 * nq * dh)
        if smem > _MAX_SMEM:       # Q and G over K and V
            smem = 2 * (2 * max(nq, nk) * dh + 2 * nq * nk)
        if nk > _ON_MAX_KEYS or smem > _MAX_SMEM:
            return None
        return {"keys": next(k for k in _ON_KEYS if nk <= k),
                "warps": min(_ON_WARPS, max(nq, nk) // 16), "smem": smem}
    if dtype == torch.float32:
        nkp, ldf = _round_up(tk, 4), dh + 4
        smem = 4 * (2 * nkp * ldf + 4 * _ON_F32_ROWS * ldf
                    + 2 * _ON_F32_ROWS * nkp)
        if tk > _ON_F32_MAX_KEYS[dh] or smem > _MAX_SMEM:
            return None
        return {"keys": (_ON_F32_KEYS if tk <= _ON_F32_KEYS
                         else _ON_F32_MAX_KEYS[dh]),
                "warps": _ON_F32_THREADS // 32, "smem": smem}
    return None


def onchip_bwd_launch_config(tq: int, tk: int, dh: int, dtype):
    """What a launch of the on-chip backward runs for Tq query rows against
    Tk keys at head dim ``dh``, as its C launcher chooses it (the library's
    ``vsd_onchip_bwd_config``, which launches nothing; the library is built
    at first use, so this needs ``nvcc``): ``{"keys", "warps", "smem"}``,
    or None where the launcher refuses the head."""
    keys, warps, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    _, fn = _entry("onchip_bwd_config")
    if fn(tq, tk, dh, int(dtype == torch.float32), ctypes.byref(keys),
          ctypes.byref(warps), ctypes.byref(smem)):
        return None
    return {"keys": keys.value, "warps": warps.value, "smem": smem.value}


def tiled_bwd_plan(batch: int, num_heads: int, dh: int, dtype) -> dict:
    """The key-tiled attention backward (``csrc/attention_bwd_tiled.cu``):
    any Tq and Tk, a head dim that is a multiple of 16 from 16 to 128, B
    and heads up to 65,535.  Two launches (dq and the rows' stats; dk and
    dv), ``warps`` a block and ``tile`` rows a staged tile; ``smem`` is the
    larger launch's dynamic shared memory (the dk / dv launch)."""
    _check_head_dim(dh, "the key-tiled attention backward")
    _check_grid(batch, num_heads)
    if dtype == torch.float32:
        tile, warps = _KT_F32_TILE, _KT_F32_WARPS
        smem = (2 * 2 * tile * (dh + 4) * 4 + 2 * tile * 16
                + warps * 2 * 32 * _F32_WSTRIDE * 4)
    else:
        tile, warps = _KT_TILE, _KT_WARPS
        smem = 2 * 2 * tile * (dh + 8) * 2 + 2 * tile * 16
    return {"route": "key_tiled", "warps": warps, "tile": tile, "smem": smem}


def attention_qkv_bwd_plan(batch: int, tp: int, num_heads: int, dh: int,
                           dtype) -> dict:
    """How :func:`attention_qkv_bwd` runs, chosen by shape before any
    launch (with :data:`BWD_PHASED` unset): ``{"route": "unphased"}``,
    kernel 4 (``csrc/attention_qkv_bwd.cu``) on the on-chip core where
    :func:`onchip_bwd_plan` holds the square Tp x Tp (bf16 up to Tp 208,
    f32 up to Tp 320 at head dim 64), with that plan's keys, warps and
    shared memory; else the key-tiled backward (:func:`tiled_bwd_plan`),
    which :func:`phased_plan` also names there."""
    _check_head_dim(dh, "the attention backward")
    _check_grid(batch, num_heads)
    plan = onchip_bwd_plan(tp, tp, dh, dtype)
    if plan is not None:
        return {"route": "unphased", **plan}
    return tiled_bwd_plan(batch, num_heads, dh, dtype)


def _onchip_qkv_bwd(entry: str, qkv, g, num_heads: int, valid_len: int):
    """Launch the on-chip core through kernel 4's or 5's C entry point
    (``entry``, counted under it or its ``_f32`` form) on CUDA ``qkv``
    and ``g`` of a shape its plan holds."""
    b, tp, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    dt, dev = qkv.dtype, qkv.device
    _require(qkv, "qkv", dt, (b, tp, d3), dev)
    _require(g, "g", dt, (b, tp, d), dev)
    f32 = dt == torch.float32
    name = entry + ("_f32" if f32 else "")
    lib, fn = _entry(entry)
    dqkv = torch.empty_like(qkv)
    err = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), int(f32), b, tp,
             d, num_heads, valid_len, float(dh) ** -0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return dqkv


def attention_qkv_bwd(qkv, g, num_heads: int, *, valid_len: int):
    """``dqkv [B, Tp, 3D]`` of the attention core on the fused projection
    ``qkv [B, Tp, 3D]`` given the head outputs' cotangent
    ``g [B, Tp, D]``, both already padded to Tp rows with ``valid_len``
    real tokens (the counterpart of the JAX ``_backward_qkv(...,
    valid_len=t)``).  ``g`` must be zero on the pad rows; ``dqkv`` then
    is zero there too.

    On the card: bf16 or f32 ``qkv`` and ``g``, B and heads up to 65,535,
    any Tp (a multiple of 8 in bf16), a head dim that is a multiple of 16
    from 16 to 128.  The route is :func:`attention_qkv_bwd_plan`'s: kernel
    4 on the on-chip core (``LAUNCHES["attention_qkv_bwd"]``, f32
    ``"attention_qkv_bwd_f32"``) where it holds the head (head dims 16, 32
    and 64; bf16 up to Tp 208; f32 up to Tp 320 at head dim 64), else
    :func:`phased_plan`'s (the key-tiled backward past it,
    ``"attention_bwd_tiled"``)."""
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, g, num_heads,
                                       valid_len=valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    b, tp, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv is {qkv.dtype}; the attention backward takes "
                        "bfloat16 or float32")
    if (tp % 8 and qkv.dtype == torch.bfloat16) or not 0 < valid_len <= tp:
        raise ValueError(
            f"the attention backward takes Tp % 8 == 0 (bf16) and 0 < "
            f"valid_len <= Tp; got Tp {tp}, valid_len {valid_len}")
    plan = attention_qkv_bwd_plan(b, tp, num_heads, dh, qkv.dtype)
    if BWD_PHASED or plan["route"] != "unphased":
        return attention_qkv_bwd_phased(qkv, g, num_heads,
                                        valid_len=valid_len)
    return _onchip_qkv_bwd("attention_qkv_bwd", qkv, g, num_heads, valid_len)


def phased_plan(batch: int, tp: int, num_heads: int, dh: int,
                dtype) -> dict:
    """How kernel 5 runs a backward of ``batch`` items of Tp rows at head
    dim ``dh``, chosen by shape before any launch.  ``route``:

    - ``"on_chip"``: one launch of ``csrc/attention_qkv_bwd_phased.cu`` on
      the on-chip core, where :func:`onchip_bwd_plan` holds the square
      (head dims 16, 32 and 64; bf16 up to Tp 208, ``keys`` the instance,
      64, 128 or 208 keys a warp holds in registers, ``warps`` a block; f32
      up to Tp 576, 448 or 320 by head dim, ``keys`` 256 or that limit);
    - ``"key_tiled"``: the key-tiled backward
      (``csrc/attention_bwd_tiled.cu``, :func:`tiled_bwd_plan`) for every
      other shape: any Tp, any head dim that is a multiple of 16 up to 128.

    ``smem`` is a block's dynamic shared memory.  Raises ``ValueError``
    naming the limit on a head dim or a grid that no route takes."""
    _check_head_dim(dh, "the phased attention backward")
    _check_grid(batch, num_heads)
    plan = onchip_bwd_plan(tp, tp, dh, dtype)
    if plan is not None:
        return {"route": "on_chip", **plan}
    return tiled_bwd_plan(batch, num_heads, dh, dtype)


def _launch_bwd_tiled(name, q, k, v, g, dq, dk, dv, *, batch, heads, dh, tq,
                      tk, ldq, ldk, ldg, bsq, bsk, bsg, valid_len):
    """Launch the key-tiled backward (``csrc/attention_bwd_tiled.cu``) on
    head-slice addresses (ints: data pointers plus element offsets) with
    their row and batch strides (elements; dq shares q's, dk and dv
    share k's), counted under ``name``."""
    f32 = g.dtype == torch.float32
    stats = torch.empty((batch, heads, tq, 4), dtype=torch.float32,
                        device=g.device)
    lib, fn = _entry("attention_bwd_tiled")
    err = fn(q, k, v, g.data_ptr(), dq, dk, dv, stats.data_ptr(), int(f32),
             batch, heads, dh, tq, tk, ldq, ldk, ldg, bsq, bsk, bsg,
             valid_len, float(dh) ** -0.5,
             torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(lib, name, err)
    LAUNCHES[name] += 1


def attention_qkv_bwd_phased(qkv, g, num_heads: int, *, valid_len: int):
    """:func:`attention_qkv_bwd` on the phase-split schedule of the TPU
    kernel ``_attn_qkv_bwd_kernel_phased`` (JAX ``ops/attention.py:259``):
    the same function, the same rounding points.  On the card: bf16 or f32
    ``qkv`` and ``g``, the route of :func:`phased_plan`: one launch of the
    on-chip core (``LAUNCHES["attention_qkv_bwd_phased"]`` or
    ``..._phased_f32``), or, past what a block holds, the key-tiled backward
    (``LAUNCHES["attention_bwd_tiled"]`` or ``..._tiled_f32``): any Tp,
    head dims that are multiples of 16 up to 128.  A CPU tensor runs
    :func:`attention_qkv_bwd_plain`, the plain version of both kernels."""
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, g, num_heads,
                                       valid_len=valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    b, tp, d3 = qkv.shape
    d = _check_head_geometry(d3, num_heads, fused=3)
    dh = d // num_heads
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv is {qkv.dtype}; the kernel takes bf16 or f32")
    if not 0 < valid_len <= tp:
        raise ValueError(f"the phased attention backward takes 0 < valid_len "
                         f"<= Tp; got valid_len {valid_len}, Tp {tp}")
    plan = phased_plan(b, tp, num_heads, dh, qkv.dtype)
    if plan["route"] == "on_chip":
        return _onchip_qkv_bwd("attention_qkv_bwd_phased", qkv, g, num_heads,
                               valid_len)
    dt, dev = qkv.dtype, qkv.device
    _require(qkv, "qkv", dt, (b, tp, d3), dev)
    _require(g, "g", dt, (b, tp, d), dev)
    dqkv = torch.empty_like(qkv)
    name = "attention_bwd_tiled" + ("_f32" if dt == torch.float32 else "")
    p, o, es = qkv.data_ptr(), dqkv.data_ptr(), qkv.element_size()
    _launch_bwd_tiled(
        name, p, p + d * es, p + 2 * d * es, g, o, o + d * es,
        o + 2 * d * es, batch=b, heads=num_heads, dh=dh, tq=tp, tk=tp,
        ldq=d3, ldk=d3, ldg=d, bsq=tp * d3, bsk=tp * d3, bsg=tp * d,
        valid_len=valid_len)
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


_F32_KEY_TILE = 128            # keys a tile of the key-tiled f32 core


def _f32_core_plan(t: int, dh: int) -> dict:
    """The f32 attention core's route (``csrc/attention_f32.cuh``) for T
    rows at head dim ``dh``: ``"whole"``, a block holding one head's K and
    V (``[T][dh + 4]`` plus each warp's 4 query rows and their ``[T][4]``
    weights, T up to 333 at head dim 64), else ``"key_tiled"``, tiles of
    128 keys with an online softmax, any T.  ``smem`` is a block's dynamic
    shared memory."""
    whole = 4 * (2 * t * (dh + 4) + _F32_WARPS * _F32_ROWS * (dh + t))
    if whole <= _MAX_SMEM:
        return {"form": "whole", "smem": whole}
    kt = _F32_KEY_TILE
    tiled = 4 * (2 * kt * (dh + 4) + _F32_WARPS * _F32_ROWS * (dh + kt))
    return {"form": "key_tiled", "keys": kt, "smem": tiled}


def module_attention_plan(t: int, dh: int, dtype) -> dict:
    """How kernels 8 and 9, the attention forward of the module path (and
    the attention stage of kernels 1 and 3, on the blocks' qkv buffer), run T
    rows at head dim ``dh``: the route that
    ``csrc/attention_self.cuh::launch_self`` takes from the same shape
    (the wrappers read it only to name the launch counter).  The bf16
    routes and the f32 one
    pass are :func:`cp_plan`'s, with its fields (``form``, the query
    ``tiles`` of a (head, item), the ``warps`` of a block, the ``keys`` a
    block stages at once, its dynamic shared memory ``smem``); the f32
    routes past it are the f32 core's (``form``, ``smem``).

    ``"one_pass"`` where the keys, rounded up to 16 in bf16 or 8 in f32,
    are at most 208 and the block fits: kernel 12's one-pass core at Tq =
    Tk = T.  Past that, the route that was faster in turns at B = 8, T
    257, 325 and 577 (``tests/torch_kernel_ab.py``, ``PERF.md`` §6):
    in bf16 kernel 12's own forms, ``"two_pass"`` with K and V whole (to T
    800 at head dim 64; kernel 1's two-pass core, the route before, took
    up to 1.6x as long) and then ``"key_tiled"`` over 256-key tiles, so
    the bf16 plan is ``cp_plan(t, t, dh, dtype)``; in f32 the routes of
    the f32 core, ``"whole"`` (to T 333 at head dim 64) and then
    ``"key_tiled"`` over 128-key tiles with an online softmax (kernel
    12's f32 two passes took 1.6-2x as long).  Any T.  Raises
    ``ValueError`` naming the limit on a head dim it does not take."""
    _check_head_dim(dh, "kernels 1, 3, 8 and 9")
    plan = cp_plan(t, t, dh, dtype)
    if dtype != torch.float32 or plan["form"] == "one_pass":
        return plan
    return _f32_core_plan(t, dh)


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
    _check_head_dim(dh, "kernel 8")
    f32 = qkv.dtype == torch.float32
    form = module_attention_plan(t, dh, qkv.dtype)["form"]
    if not 0 < b <= 65535 or num_heads > 65535 or t < 1:
        raise ValueError(f"batch {b} / heads {num_heads} / T {t} outside "
                         "the grid")
    _require(qkv, "qkv", qkv.dtype, (b, t, d3), qkv.device)
    lib, fn = _entry("attention_qkv")
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    err = fn(qkv.data_ptr(), out.data_ptr(), int(f32), b, t, d, num_heads, t,
             float(dh) ** -0.5, torch.cuda.current_stream(qkv.device).cuda_stream)
    name = ("attention_qkv_f32_tiled" if f32 else "attention_qkv_tiled") if (
        form == "key_tiled") else "attention_qkv"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
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
    kernel 8 (``LAUNCHES["attention_qkv"]``) on bf16 or f32, any B and T,
    a head dim that is a multiple of 16 from 16 to 128, on the route of
    :func:`module_attention_plan` (kernel 12's one-pass core up to 208
    keys; past the T whose K and V fit a block, 800 at head dim 64 in
    bf16 and 333 in f32, the key-tiled routes ``"attention_qkv_tiled"``,
    ``"attention_qkv_f32_tiled"``).  Differentiable: the
    backward is :func:`attention_qkv_bwd` (bf16 or f32, any T) on the card
    and its plain version on the CPU."""
    if not qkv.is_contiguous():
        qkv = qkv.contiguous()
    if torch.compiler.is_exporting():
        return attention_qkv_op(qkv, num_heads)
    return _AttentionQKV.apply(qkv, num_heads)


# --------------------------------------------------------------------------
# Sequence parallelism: a local query block against the gathered keys
# (kernels 12 and 13)
# --------------------------------------------------------------------------


def _cp_heads(q, kv, num_heads: int):
    """``(b, tq, tk, d, dh)`` of a query block ``q [B, Tq, D]`` and the
    gathered ``kv [B, Tk, 2D]``; raises on mismatched shapes."""
    b, tq, d = q.shape
    d = _check_head_geometry(d, num_heads)
    if kv.dim() != 3 or kv.shape[0] != b or kv.shape[2] != 2 * d:
        raise ValueError(f"kv has shape {tuple(kv.shape)}; expected "
                         f"[{b}, Tk, {2 * d}] for q {tuple(q.shape)}")
    return b, tq, kv.shape[1], d, d // num_heads


def _cp_views(q, kv, num_heads: int):
    """Per-head views: q ``[B, H, Tq, dh]``, k and v ``[B, H, Tk, dh]``."""
    b, tq, tk, d, dh = _cp_heads(q, kv, num_heads)
    qh = q.reshape(b, tq, num_heads, dh).transpose(1, 2)
    k, v = kv.reshape(b, tk, 2, num_heads, dh).permute(2, 0, 3, 1, 4)
    return qh, k, v


def fused_attention_qkv_cp_plain(q, kv, num_heads: int, valid_len: int):
    """Plain PyTorch version of kernel 12 (JAX ``_attn_cp_kernel`` :836,
    whose oracle is ``_cp_dense_reference`` :1006): per head the f32
    logits ``q k^T * dh^-0.5`` of the local queries ``q [B, Tq, D]``
    against the gathered keys ``kv [B, Tk, 2D]`` (``[k | v]``), key
    columns at or past ``valid_len`` at -1e30, the f32 softmax, the
    weights rounded to ``kv.dtype`` before ``@ v`` with f32 sums, the
    output ``[B, Tq, D]`` rounded once to ``q.dtype``."""
    b, tq, _tk, d, dh = _cp_heads(q, kv, num_heads)
    with exact_f32_matmul():
        qh, k, v = _cp_views(q, kv, num_heads)
        w = _softmax_weights(qh, k, float(dh) ** -0.5, valid_len)
        heads = _mm(w.to(kv.dtype), v)                        # [B,H,Tq,dh]
        return heads.transpose(1, 2).reshape(b, tq, d).to(q.dtype)


def attention_cp_bwd_plain(q, kv, g, num_heads: int, valid_len: int):
    """Plain PyTorch version of kernel 13 (JAX ``_attn_cp_bwd_kernel``
    :865): ``(dq [B, Tq, D], dkv [B, Tk, 2D])`` of kernel 12 given the
    cotangent ``g [B, Tq, D]`` of its output.  Per head the f32 softmax
    ``w`` recomputed, ``dv = w^T g``, ``dw = g v^T``, ``dl = w (dw -
    rowsum(dw w))``, ``dq = dl k s``, ``dk = dl^T q s``, rounding where
    the TPU kernel does (to the input dtype): ``w`` before ``dv``, ``dl``
    (from the f32 ``w`` and ``dw``) before ``dq`` and ``dk``, and the
    outputs.  Key columns at or past ``valid_len`` get exactly zero ``dk``
    and ``dv``; ``dkv`` is this block's contribution to every key."""
    b, tq, tk, d, dh = _cp_heads(q, kv, num_heads)
    cdt = q.dtype
    scale = float(dh) ** -0.5
    with exact_f32_matmul():
        qh, k, v = _cp_views(q, kv, num_heads)
        gh = g.to(cdt).reshape(b, tq, num_heads, dh).transpose(1, 2)
        w = _softmax_weights(qh, k, scale, valid_len)          # [B,H,Tq,Tk]
        dv = _mm(w.to(cdt).transpose(-1, -2), gh)
        dw = _mm(gh, v.transpose(-1, -2))
        dl = (w * (dw - (dw * w).sum(-1, keepdim=True))).to(cdt)
        dq = _mm(dl, k) * scale
        dk = _mm(dl.transpose(-1, -2), qh) * scale
        dq = dq.transpose(1, 2).reshape(b, tq, d).to(cdt)
        dkv = torch.stack([dk, dv], dim=2)                     # [B,H,2,Tk,dh]
        return dq, dkv.permute(0, 3, 2, 1, 4).reshape(b, tk, 2 * d).to(cdt)


def _check_cp_args(q, kv, num_heads, valid_len, what):
    """Raise on what kernels 12 and 13 share: dtype, device, shapes, the
    mask bound, the grid; returns ``(b, tq, tk, d, dh)``."""
    b, tq, tk, d, dh = _cp_heads(q, kv, num_heads)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q is {q.dtype}; {what} takes bfloat16 or float32")
    if kv.dtype != q.dtype or kv.device != q.device:
        raise TypeError(f"q and kv must share dtype and device; got "
                        f"{q.dtype} on {q.device}, {kv.dtype} on {kv.device}")
    if not 0 < valid_len <= tk:
        raise ValueError(f"{what} takes 0 < valid_len <= Tk; got valid_len "
                         f"{valid_len}, Tk {tk}")
    if not 0 < b <= 65535 or num_heads > 65535 or tq < 1:
        raise ValueError(f"batch {b} / heads {num_heads} / Tq {tq} outside "
                         "the grid")
    _require(q, "q", q.dtype, (b, tq, d), q.device)
    _require(kv, "kv", q.dtype, (b, tk, 2 * d), q.device)
    return b, tq, tk, d, dh


_CP_WARPS = 7                     # kernel 12, bf16: warps of 16 query rows
_CP_ONE_PASS_KEYS = 208           # keys a one-pass block holds in registers


_CP_KEY_TILE, _CP_F32_KEY_TILE = 256, 128   # kernel 12's key tiles


def _cp_key_tile(tk: int, dh: int, f32: bool) -> int:
    """Keys a two-pass block of kernel 12 stages at once
    (``attention_cp_core.cuh::cp_key_tile``): all of them (Tk rounded up to
    16 in bf16, 8 in f32) where K and V fit beside the f32 form's weight
    chunks, else tiles of 256 keys (bf16) or 128 (f32), small enough for
    two or more blocks an SM."""
    if not f32:
        nk = _round_up(tk, 16)
        return nk if nk * 2 * (dh + 8) * 2 <= _MAX_SMEM else _CP_KEY_TILE
    nk = _round_up(tk, 8)
    if 8 * 32 * _F32_WSTRIDE * 4 + nk * 2 * (dh + 4) * 4 <= _MAX_SMEM:
        return nk
    return _CP_F32_KEY_TILE


def cp_plan(tq: int, tk: int, dh: int, dtype) -> dict:
    """How kernel 12 (``csrc/attention_cp.cu``) runs Tq query rows against
    Tk keys at head dim ``dh``, chosen by shape before the launch: its
    ``form`` (``"one_pass"`` where the keys, rounded up to 16 in bf16 or 8
    in f32, are at most 208 and every score stays in registers;
    ``"two_pass"`` past them, and in f32 wherever the one-pass block does
    not fit, with K and V staged whole; ``"key_tiled"``, the two passes
    over tiles of ``keys`` keys (256 bf16, 128 f32), where K and V do not
    fit: bf16 past Tk 800 at head dim 64, f32 past 384), the query
    ``tiles`` of a (head, item),
    the ``warps`` of a block, the ``keys`` a block stages at once and its
    dynamic shared memory ``smem``.  Any Tq and Tk.  Raises
    ``ValueError`` naming the limit on a head dim it does not take."""
    _check_head_dim(dh, "kernel 12")
    groups = -(-tq // 16)
    f32 = dtype == torch.float32
    kt = _cp_key_tile(tk, dh, f32)
    if not f32:
        tiles = -(-groups // _CP_WARPS)
        warps = -(-groups // tiles)
        nk = _round_up(tk, 16)
        one_pass = nk <= _CP_ONE_PASS_KEYS
        smem = (warps * 16 + 2 * nk if one_pass else 2 * kt) * (dh + 8) * 2
    else:                      # 8 groups of 16 rows a block
        tiles = -(-groups // 8)
        nk = _round_up(tk, 8)
        # one pass, two warps a group: K and V [nk][dh + 4], 16 weight
        # chunks [32][20], the halves' row max and sum, the second half's
        # partial outputs [8][16][dh]; two passes, a warp a group: K and V
        # (or their tiles) and 8 weight chunks
        one = (2 * nk * (dh + 4) + 16 * 32 * 20 + 512 + 8 * 16 * dh) * 4
        one_pass = nk <= _CP_ONE_PASS_KEYS and one <= _MAX_SMEM
        warps = 16 if one_pass else 8
        smem = one if one_pass else (2 * kt * (dh + 4) + 8 * 32 * 20) * 4
    form = ("one_pass" if one_pass else
            "two_pass" if kt >= nk else "key_tiled")
    return {"form": form, "tiles": tiles, "warps": warps,
            "keys": nk if kt >= nk else kt, "smem": smem}


def _attention_cp_kernel(q, kv, num_heads: int, valid_len: int):
    """Launch kernel 12 (``csrc/attention_cp.cu``) on CUDA ``q [B, Tq, D]``
    and ``kv [B, Tk, 2D]``; raises on what it does not take."""
    b, tq, tk, d, dh = _check_cp_args(q, kv, num_heads, valid_len,
                                      "kernel 12")
    plan = cp_plan(tq, tk, dh, q.dtype)
    lib, fn = _entry("attention_cp")
    out = torch.empty((b, tq, d), dtype=q.dtype, device=q.device)
    f32 = q.dtype == torch.float32
    err = fn(q.data_ptr(), kv.data_ptr(), out.data_ptr(), int(f32), b, tq,
             tk, d, num_heads, valid_len, float(dh) ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    name = ("attention_cp" + ("_tiled" if plan["form"] == "key_tiled" else "")
            + ("_f32" if f32 else ""))
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return out


def cp_bwd_plan(batch: int, tq: int, tk: int, num_heads: int, dh: int,
                dtype) -> dict:
    """How kernel 13 runs, chosen by shape before any launch:
    ``{"route": "on_chip"}``, ``csrc/attention_cp_bwd.cu`` on the on-chip
    core where :func:`onchip_bwd_plan` holds the ``[Tq, Tk]`` rectangle
    (head dims 16, 32 and 64; bf16 Tk up to 208 with the ``[Tq, Tk]`` bf16
    weights within shared memory; f32 Tk up to 320 at head dim 64, any
    Tq), with that plan's keys, warps and shared memory; else the
    rectangular instance of the key-tiled backward
    (:func:`tiled_bwd_plan`): any Tq and Tk."""
    _check_head_dim(dh, "kernel 13")
    _check_grid(batch, num_heads)
    plan = onchip_bwd_plan(tq, tk, dh, dtype)
    if plan is not None:
        return {"route": "on_chip", **plan}
    return tiled_bwd_plan(batch, num_heads, dh, dtype)


def _attention_cp_bwd_kernel(q, kv, g, num_heads: int, valid_len: int):
    """Launch kernel 13 on the route of :func:`cp_bwd_plan`: ``(dq, dkv)``
    on CUDA ``q``, ``kv`` and ``g [B, Tq, D]``; raises on what it does not
    take."""
    b, tq, tk, d, dh = _check_cp_args(q, kv, num_heads, valid_len,
                                      "kernel 13")
    f32 = q.dtype == torch.float32
    plan = cp_bwd_plan(b, tq, tk, num_heads, dh, q.dtype)
    _require(g, "g", q.dtype, (b, tq, d), q.device)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    if plan["route"] == "key_tiled":
        es, pk, pd = q.element_size(), kv.data_ptr(), dkv.data_ptr()
        _launch_bwd_tiled(
            "attention_cp_bwd_tiled" + ("_f32" if f32 else ""),
            q.data_ptr(), pk, pk + d * es, g, dq.data_ptr(), pd, pd + d * es,
            batch=b, heads=num_heads, dh=dh, tq=tq, tk=tk, ldq=d, ldk=2 * d,
            ldg=d, bsq=tq * d, bsk=tk * 2 * d, bsg=tq * d,
            valid_len=valid_len)
        return dq, dkv
    lib, fn = _entry("attention_cp_bwd")
    err = fn(q.data_ptr(), kv.data_ptr(), g.data_ptr(), dq.data_ptr(),
             dkv.data_ptr(), int(f32), b, tq, tk, d, num_heads, valid_len,
             float(dh) ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    name = "attention_cp_bwd_f32" if f32 else "attention_cp_bwd"
    _build.check(lib, name, err)
    LAUNCHES[name] += 1
    return dq, dkv


def attention_cp_bwd(q, kv, g, num_heads: int, valid_len: int):
    """``(dq, dkv)`` of :func:`fused_attention_qkv_cp` given its output's
    cotangent ``g``: kernel 13 on a CUDA tensor, its plain version on a
    CPU one."""
    g = g.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        return attention_cp_bwd_plain(q, kv, g, num_heads, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _attention_cp_bwd_kernel(q, kv, g, num_heads, valid_len)


class _AttentionCP(torch.autograd.Function):
    """Kernel 12 forward, kernel 13 backward (the JAX ``custom_vjp`` of
    ``fused_attention_qkv_cp``)."""

    @staticmethod
    def forward(ctx, q, kv, num_heads, valid_len):
        ctx.num_heads, ctx.valid_len = num_heads, valid_len
        ctx.save_for_backward(q, kv)
        if q.device.type == "cpu":
            return fused_attention_qkv_cp_plain(q, kv, num_heads, valid_len)
        if q.device.type != "cuda":
            raise ValueError(f"no kernel for device {q.device}")
        return _attention_cp_kernel(q, kv, num_heads, valid_len)

    @staticmethod
    def backward(ctx, g):
        q, kv = ctx.saved_tensors
        dq, dkv = attention_cp_bwd(q, kv, g, ctx.num_heads, ctx.valid_len)
        return dq, dkv, None, None


def fused_attention_qkv_cp(q, kv, num_heads: int, valid_len: int):
    """Rectangular attention of sequence parallelism (counterpart of the
    JAX ``fused_attention_qkv_cp`` :987): the local query block ``q [B,
    Tq, D]`` against the gathered ``kv [B, Tk, 2D]`` (``[k | v]``, heads
    contiguous inside each), keys at or past ``valid_len`` masked ->
    ``[B, Tq, D]`` in ``q.dtype``.

    A CPU tensor runs :func:`fused_attention_qkv_cp_plain`; a CUDA one
    runs kernel 12 (``LAUNCHES["attention_cp"]``, f32
    ``"attention_cp_f32"``; its key tiles past the Tk whose K and V fit,
    ``"attention_cp_tiled"``, ``"attention_cp_tiled_f32"``) on bf16 or
    f32, any Tq and Tk (:func:`cp_plan`; the TPU kernel's zero padding to
    multiples of 8 adds nothing), a head dim that is a multiple of 16
    from 16 to 128.  Differentiable: the backward is kernel 13 (the
    on-chip core, a block a (head, item), for head dims 16, 32 and 64,
    bf16 Tk up to 208 and f32 up to 320; the key-tiled backward past that,
    :func:`cp_bwd_plan`) or its plain version."""
    return _AttentionCP.apply(q.contiguous(), kv.contiguous(), num_heads,
                              valid_len)


# the mesh model code runs under, whether the caller is a pipeline stage's
# body (manual_attention), and the sequence- and tensor-parallel
# dispatches made (on any device; JAX's ``pallas_calls``), which tests and
# parallel/dryrun.py read to see that those paths ran
_context = {"mesh": None, "manual": False, "cp_calls": 0, "tp_calls": 0}


@contextlib.contextmanager
def attention_sharding(mesh=None):
    """The mesh that model code runs under (JAX ``attention_sharding``
    :645): :func:`dispatch_attention_qkv` and ``models/vit.py::ViT``
    read it, so the module needs no mesh argument.  ``None`` restores the
    single-card path."""
    prev = _context["mesh"]
    _context["mesh"] = mesh
    try:
        yield
    finally:
        _context["mesh"] = prev


@contextlib.contextmanager
def manual_attention(mesh=None):
    """Dispatch for the body of a pipeline stage (JAX ``manual_attention``
    :624): the blocks run on this rank's microbatch inside
    ``parallel/pipeline.py``'s schedule, under ``mesh`` (the pipeline's,
    whatever mesh an enclosing :func:`attention_sharding` holds).  With a
    ``model`` axis the attention runs on the rank's heads, as JAX's
    ``_tp_head_sharded_nested`` (:771) does; without one kernel 8 runs on
    the whole microbatch."""
    prev = dict(_context)
    _context.update(mesh=mesh, manual=True)
    try:
        yield
    finally:
        _context.update(mesh=prev["mesh"], manual=prev["manual"])


def current_mesh():
    """The mesh of the enclosing :func:`attention_sharding` (or
    :func:`manual_attention`), or None."""
    return _context["mesh"]


def _sp_sharded(qkv, num_heads: int, mesh, valid_len: int):
    """Attention under sequence parallelism (JAX ``_sp_sharded`` :1024):
    the all-gather-KV form of context parallelism.  ``qkv [B_l, Tl, 3D]``
    is this rank's contiguous block of the padded token stream; its K and
    V (2/3 of the stream) are gathered along the ``seq`` group into
    ``[B_l, Tp, 2D]`` and kernel 12 runs the local queries against them,
    keys at or past ``valid_len`` (the real token count) masked.  In the
    backward, kernel 13's partial dkv reduce-scatters back to the rank
    that owns each key.  No ring schedule: at T = 197 one gather of the
    keys is all the exchange there is."""
    from ..parallel.collectives import all_gather_seq
    from ..parallel.mesh import SEQ_AXIS

    d = qkv.shape[-1] // 3
    _context["cp_calls"] += 1
    kv = all_gather_seq(qkv[..., d:], mesh.get_group(SEQ_AXIS))
    return fused_attention_qkv_cp(qkv[..., :d], kv, num_heads, valid_len)


def dispatch_attention_qkv(qkv, num_heads: int, *, mesh=None,
                           valid_len=None):
    """The attention core of ``models/vit.py::Attention`` (JAX
    ``dispatch_attention_qkv`` :663) under ``mesh`` (by default the
    :func:`attention_sharding` or :func:`manual_attention` context's):

    - no mesh, or a data-only mesh: kernel 8 on this rank's rows (its
      plain version on a CPU tensor);
    - a ``seq`` axis larger than 1 (outside a pipeline stage):
      :func:`_sp_sharded`, kernel 12 on the local query block against the
      gathered keys; ``valid_len`` is the real token count of the
      gathered stream (pad keys past it masked);
    - a ``model`` axis of n > 1 ranks (JAX ``_tp_head_sharded`` :795 and
      ``_tp_head_sharded_nested`` :771): when n divides ``num_heads``,
      ``qkv`` is this rank's stream ``[B, T, 3 D / n]``, the ``[q | k |
      v]`` of its H / n heads (``models/vit.py::Attention`` projects onto
      the rank's columns, ``parallel/mesh.py::head_major_index``), and
      kernel 8 runs at H / n heads; the output ``[B, T, D / n]`` is the
      rank's heads, the rows of proj it holds.  When n does not divide
      the heads the layer was kept whole and ``qkv`` is the full stream:
      kernel 8 at H heads, JAX's dense result."""
    mesh = _context["mesh"] if mesh is None else mesh
    if mesh is not None:
        from ..parallel.mesh import MODEL_AXIS, SEQ_AXIS, axis_sizes
        sizes = axis_sizes(mesh)
        n_model = sizes.get(MODEL_AXIS, 1)
        if n_model > 1 and num_heads % n_model == 0:
            _context["tp_calls"] += 1
            return fused_attention_qkv(qkv, num_heads // n_model)
        if sizes.get(SEQ_AXIS, 1) > 1 and not _context["manual"]:
            if valid_len is None:
                raise ValueError("sequence-parallel attention needs "
                                 "valid_len, the real token count")
            return _sp_sharded(qkv, num_heads, mesh, valid_len)
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
    _check_head_dim(dh, "kernel 9")
    f32 = q.dtype == torch.float32
    form = module_attention_plan(t, dh, q.dtype)["form"]
    if not 0 < b <= 65535 or not 0 < h <= 65535 or t < 1:
        raise ValueError(f"batch {b} / heads {h} / T {t} outside the grid")
    strides = _attention_strides(q, k, v)
    if strides is None:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        strides = _attention_strides(q, k, v)
    lib, fn = _entry("attention")
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(f32), b, t, h, dh, *strides, float(dh) ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    name = ("attention_f32" if f32 else "attention") + (
        "_tiled" if form == "key_tiled" else "")
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
    form ``"attention_f32"``) on bf16 or f32, any B and T, a head dim
    that is a multiple of 16 from 16 to 128, on kernel 8's routes
    (:func:`module_attention_plan`; key-tiled: ``"attention_tiled"``,
    ``"attention_f32_tiled"``).  q,
    k and v may be strided views (the int8 path passes the three slices
    of one ``[B, T, 3, H, Dh]`` projection) as long as they share strides
    with heads and head columns contiguous; otherwise they are copied.
    Differentiable: the backward is :func:`fused_attention_backward`."""
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


MLP_LN_ROWS = 8       # rows a block of the LayerNorm launch (a warp a row)


def mlp_block_plan(rows: int, d: int, hidden: int,
                   sms: int = _gemm.H100_SMS) -> dict:
    """Kernel 2's launches for ``rows`` x ``d`` with a ``hidden``-wide MLP
    on ``sms`` SMs, as ``csrc/mlp_block.cu`` makes them: the LayerNorm
    (``ln``: a warp a row, ``rows_per_block`` rows a block of ``threads``,
    ``blocks`` of them) into the bf16 scratch ``xn``, then fc1 with the
    GELU epilogue into the hidden scratch and fc2 with the residual
    epilogue, each on the GEMM core's plan (:func:`ops.gemm.gemm_plan`).
    ``scratch`` gives the two scratch tensors' bytes.  Raises
    ``ValueError`` naming the limit on D or hidden that are not multiples
    of 8, or on rows < 1."""
    if d % 8 or hidden % 8 or d <= 0 or hidden <= 0:
        raise ValueError(f"the MLP kernel takes D and hidden that are "
                         f"multiples of 8; got D {d}, hidden {hidden}")
    if rows < 1:
        raise ValueError(f"the MLP plan needs rows >= 1; got {rows}")
    return {"launches": ("ln", "fc1", "fc2"),
            "ln": {"rows_per_block": MLP_LN_ROWS,
                   "blocks": -(-rows // MLP_LN_ROWS),
                   "threads": 32 * MLP_LN_ROWS},
            "fc1": _gemm.gemm_plan(rows, hidden, d, sms),
            "fc2": _gemm.gemm_plan(rows, d, hidden, sms),
            "scratch": {"xn": rows * d * 2, "hidden": rows * hidden * 2}}


def mlp_block_launch_config(rows: int, d: int, hidden: int,
                            sms: int = 0) -> dict:
    """Kernel 2's plan as its C launcher reports it (``vsd_mlp_block_plan``,
    on this card's SM count when ``sms`` is 0), with
    :func:`mlp_block_plan`'s keys but ``scratch``.  Needs the card."""
    keys = _gemm.PLAN_KEYS
    n = 3 + 2 * len(keys)
    lib, fn = _entry("mlp_block_plan")
    out = (_I * n)()
    got = fn(rows, d, hidden, sms, out, n)
    if got != n:
        raise RuntimeError(f"vsd_mlp_block_plan returned {got} values")
    v = list(out)
    return {"launches": ("ln", "fc1", "fc2"),
            "ln": dict(zip(("rows_per_block", "blocks", "threads"), v[:3])),
            "fc1": dict(zip(keys, v[3:3 + len(keys)])),
            "fc2": dict(zip(keys, v[3 + len(keys):]))}


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
