"""The whole ViT encoder as one kernel launch, for small-batch serving
(counterpart of the JAX package's ``ops/lowlat.py``).

- :func:`encoder_forward_lowlat`: a padded ``[B, Tp, D]`` stream through
  every layer of the per-item pack (:func:`pack_encoder_weights`).
- :func:`forward_lowlat_e2e`: patch rows -> anti-spoof logits ``[B, 2]``,
  the stem and the head folded around the encoder ("fold-ends",
  :func:`pack_end_weights`).
  Kernel of both: ``csrc/lowlat_encoder.cu``; replaces the TPU kernel
  ``_encoder_kernel`` (JAX ``ops/lowlat.py:94``).
- :func:`encoder_forward_lowlat_batchgrid`: up to 4 items through the
  batch-grid pack (:func:`pack_encoder_weights_batchgrid`: each MLP in two
  half-width steps, an f32 partial sum between them).  Kernel:
  ``csrc/lowlat_batchgrid.cu``; replaces ``_encoder_batchgrid_kernel``
  (JAX ``ops/lowlat.py:241``).

The packs keep the JAX layout element for element: ``W [3*depth, D, 4D]``
superblocks (``[Wqkv | Wproj]``, fc1, fc2's row chunks side by side) and
``S [3*depth, 4, 4D]`` f32 rows of LN and bias vectors.  The kernels read
that layout as it is; its VMEM-driven shape is not what they are built
around (the source notes in ``csrc/`` give their design).

Rounding points are the TPU kernels': LN, softmax and every sum in f32;
xn, qkv, the softmax weights, the head outputs, the GELU output and each
sub-layer's output rounded to the stream's dtype.  The head's erf GELU
uses ``erf`` (the TPU kernel's A&S rational differs by at most 1.5e-7
before a bf16 rounding).

A CPU tensor goes to the plain PyTorch version beside each wrapper
(``*_plain``); a CUDA tensor goes to the kernel, which takes bf16 and
raises on anything else.  :data:`LAUNCHES` counts the kernel calls.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..device import exact_f32_matmul
from . import _build
from .attention import (_layernorm_f32, _mm, _require, _round_up,
                        _softmax_weights)
from .gelu import gelu

LAUNCHES = _build.LAUNCHES

_INT8_TODO = ("int8 weight streaming (kernel 10's dequant branch) is not "
              "ported yet: ROADMAP Queue 2 item 17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "lowlat_encoder": ("vsd_lowlat_encoder", [_P] * 14 + [_I, _P]
                       + [_I] * 7 + [_F] * 3 + [_P]),
    "lowlat_batchgrid": ("vsd_lowlat_batchgrid", [_P] * 10 + [_I, _P]
                         + [_I] * 6 + [_F] * 2 + [_P]),
}


def _entry(name: str):
    return _build.entry(name, *_SIGNATURES[name])


# --------------------------------------------------------------------------
# packing (plain layout work, done once)
# --------------------------------------------------------------------------


def _leaf(x, dtype, device=None) -> torch.Tensor:
    """A parameter leaf (tensor or array) as a ``dtype`` tensor."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device if device is not None else x.device,
                dtype=dtype)


def _check_weight_dtype(weight_dtype):
    if weight_dtype is None:
        return
    if weight_dtype == torch.int8:
        raise NotImplementedError(_INT8_TODO)
    raise ValueError(f"weight_dtype must be int8 or None, got {weight_dtype}")


def _pack_geom(vit_params):
    """(d, hidden) of the encoder, validating the uniform-superblock
    invariant every lowlat pack relies on (3D + D == hidden)."""
    blk0 = vit_params["block0"]
    d = blk0["attn"]["qkv"]["kernel"].shape[0]
    hidden = blk0["mlp"]["fc1"]["kernel"].shape[1]
    if hidden != 4 * d:
        raise ValueError(
            f"lowlat packing needs mlp hidden == 4*embed ({hidden} != "
            f"4*{d}) — the uniform superblock relies on 3D+D == hidden")
    return d, hidden


def _pack_attn_step(blk, d, hidden, dtype, device):
    """Step-0 superblock ``[wqkv | wproj]`` and its S block, the same in
    the per-item and batch-grid layouts."""
    f32 = torch.float32
    w = torch.cat([_leaf(blk["attn"]["qkv"]["kernel"], dtype, device),
                   _leaf(blk["attn"]["proj"]["kernel"], dtype, device)], 1)
    s0 = torch.zeros((4, hidden), dtype=f32, device=w.device)
    s0[0, :d] = _leaf(blk["norm1"]["scale"], f32, device)
    s0[1, :d] = _leaf(blk["norm1"]["bias"], f32, device)
    s0[2, :3 * d] = _leaf(blk["attn"]["qkv"]["bias"], f32, device)
    s0[3, :d] = _leaf(blk["attn"]["proj"]["bias"], f32, device)
    return w, s0


def pack_encoder_weights(vit_params, *, depth: int = 12,
                         dtype=torch.bfloat16, weight_dtype=None,
                         device=None):
    """The per-item pack: ``(W [3*depth, D, 4D] dtype, S [3*depth, 4, 4D]
    f32)``, step ``3l`` = ``[Wqkv | Wproj]``, ``3l+1`` = fc1, ``3l+2`` =
    fc2's four ``[D, D]`` row chunks side by side; S rows as the JAX
    package packs them.  ``weight_dtype=torch.int8`` (the opt-in int8
    stream) raises ``NotImplementedError``."""
    _check_weight_dtype(weight_dtype)
    d, hidden = _pack_geom(vit_params)
    f32 = torch.float32
    ws, ss = [], []
    for i in range(depth):
        blk = vit_params[f"block{i}"]
        w0, s0 = _pack_attn_step(blk, d, hidden, dtype, device)
        mlp = blk["mlp"]
        s1 = torch.zeros((4, hidden), dtype=f32, device=w0.device)
        s1[0, :d] = _leaf(blk["norm2"]["scale"], f32, device)
        s1[1, :d] = _leaf(blk["norm2"]["bias"], f32, device)
        s1[2, :] = _leaf(mlp["fc1"]["bias"], f32, device)
        fc2 = _leaf(mlp["fc2"]["kernel"], dtype, device)
        s2 = torch.zeros((4, hidden), dtype=f32, device=w0.device)
        s2[0, :d] = _leaf(mlp["fc2"]["bias"], f32, device)
        ws += [w0, _leaf(mlp["fc1"]["kernel"], dtype, device),
               torch.cat([fc2[c * d:(c + 1) * d] for c in range(hidden // d)],
                         1)]
        ss += [s0, s1, s2]
    return torch.stack(ws).contiguous(), torch.stack(ss).contiguous()


def pack_encoder_weights_batchgrid(vit_params, *, depth: int = 12,
                                   dtype=torch.bfloat16, device=None):
    """The batch-grid pack: the shapes of :func:`pack_encoder_weights`,
    but steps ``3l+1`` / ``3l+2`` each carry half the MLP,
    ``W = [fc1[:, half] | fc2[half rows as two D-chunks]]``, ``S = [ln2
    scale, ln2 bias, fc1 bias half, 0 | fc2 bias]``."""
    d, hidden = _pack_geom(vit_params)
    f32 = torch.float32
    ws, ss = [], []
    for i in range(depth):
        blk = vit_params[f"block{i}"]
        w0, s0 = _pack_attn_step(blk, d, hidden, dtype, device)
        ws.append(w0)
        ss.append(s0)
        mlp = blk["mlp"]
        fc1 = _leaf(mlp["fc1"]["kernel"], dtype, device)
        fc1_b = _leaf(mlp["fc1"]["bias"], f32, device)
        fc2 = _leaf(mlp["fc2"]["kernel"], dtype, device)
        for half in range(2):
            lo = half * 2 * d
            ws.append(torch.cat([fc1[:, lo:lo + 2 * d], fc2[lo:lo + d],
                                 fc2[lo + d:lo + 2 * d]], 1))
            sh = torch.zeros((4, hidden), dtype=f32, device=w0.device)
            sh[0, :d] = _leaf(blk["norm2"]["scale"], f32, device)
            sh[1, :d] = _leaf(blk["norm2"]["bias"], f32, device)
            sh[2, :2 * d] = fc1_b[lo:lo + 2 * d]
            if half:
                sh[3, :d] = _leaf(mlp["fc2"]["bias"], f32, device)
            ss.append(sh)
    return torch.stack(ws).contiguous(), torch.stack(ss).contiguous()


def pack_end_weights(params, *, dtype=torch.bfloat16, device=None):
    """The stem and the anti-spoof head for the fold-ends kernel:
    ``(w_end [1, D, D+Hh] dtype, s_end [1, 4, 4D] f32, aux [1, Tp, D]
    f32)``.  ``w_end[:, :D]`` is the patch-embed kernel, ``w_end[:, D:]``
    the head's fc1; ``s_end`` rows 0/1 hold vit.norm (``:D``), head.norm
    (``D:2D``) and the head's fc2 columns (``2D:2D+Hh``, rounded through
    ``dtype``), row 2 the fc1 bias, row 3 the fc2 bias; ``aux`` is the pos
    embed plus the embed bias (row 0: cls token + pos 0; pad rows zero).

    Raises ValueError where the shapes cannot ride the layout
    (patch_dim != D, 2D + Hh > 4D, no anti-spoof head); callers then use
    the encoder-only kernel."""
    if "head" not in params:
        raise ValueError("fold-ends needs the anti-spoof head "
                         "(linear-head trees use the encoder-only kernel)")
    vit, head = params["vit"], params["head"]
    pe_k = vit["patch_embed"]["kernel"]
    patch_dim, d = pe_k.shape
    hidden = vit["block0"]["mlp"]["fc1"]["kernel"].shape[1]
    fc1_k, fc2_k = head["fc1"]["kernel"], head["fc2"]["kernel"]
    hh = fc1_k.shape[1]
    if patch_dim != d:
        raise ValueError(
            f"fold-ends needs patch_dim == embed_dim ({patch_dim} != {d})"
            " — the embed GEMM must share the head's resident block")
    if 2 * d + hh > hidden:
        raise ValueError(f"fold-ends needs 2*D + head_hidden <= 4*D "
                         f"({2 * d} + {hh} > {hidden})")
    if fc2_k.shape[1] != 2:
        raise ValueError("fold-ends supports the 2-logit anti-spoof head")
    f32 = torch.float32
    w_end = torch.cat([_leaf(pe_k, dtype, device),
                       _leaf(fc1_k, dtype, device)], 1)
    dev = w_end.device
    s_end = torch.zeros((4, hidden), dtype=f32, device=dev)
    s_end[0, :d] = _leaf(vit["norm"]["scale"], f32, device)
    s_end[1, :d] = _leaf(vit["norm"]["bias"], f32, device)
    s_end[0, d:2 * d] = _leaf(head["norm"]["scale"], f32, device)
    s_end[1, d:2 * d] = _leaf(head["norm"]["bias"], f32, device)
    s_end[2, :hh] = _leaf(head["fc1"]["bias"], f32, device)
    fc2 = _leaf(fc2_k, dtype, device).to(f32)
    s_end[0, 2 * d:2 * d + hh] = fc2[:, 0]
    s_end[1, 2 * d:2 * d + hh] = fc2[:, 1]
    s_end[3, :2] = _leaf(head["fc2"]["bias"], f32, device)

    pos = _leaf(vit["pos_embed"], f32, device).reshape(-1, d)    # [T, D]
    t = pos.shape[0]
    aux = torch.zeros((_round_up(t, 8), d), dtype=f32, device=dev)
    aux[1:t] = pos[1:] + _leaf(vit["patch_embed"]["bias"], f32, device)
    aux[0] = pos[0] + _leaf(vit["cls_token"], f32, device).reshape(d)
    return (w_end[None].contiguous(), s_end[None].contiguous(),
            aux[None].contiguous())


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _attn_sublayer_plain(x32, w_blk, s_blk, *, num_heads: int,
                         valid_len: int, eps: float, out_dtype):
    """One pre-LN attention sub-layer on an f32 ``[B, Tp, D]`` residual:
    LN1 -> fused QKV GEMM -> masked per-head softmax attention -> proj ->
    residual add, rounded to ``out_dtype``.  ``w_blk`` is a ``[D, 4D]``
    step-0 superblock, ``s_blk`` its ``[4, 4D]`` S block.  Shared by the
    per-item and batch-grid plain versions."""
    b, tp, d = x32.shape
    dh = d // num_heads
    xn = _layernorm_f32(x32, s_blk[0, :d], s_blk[1, :d], eps).to(out_dtype)
    qkv = (_mm(xn, w_blk[:, :3 * d]) + s_blk[2, :3 * d]).to(out_dtype)
    q, k, v = qkv.view(b, tp, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    w = _softmax_weights(q, k, float(dh) ** -0.5, valid_len)
    heads = _mm(w.to(out_dtype), v)                          # [B,H,Tp,dh]
    attn = heads.permute(0, 2, 1, 3).reshape(b, tp, d).to(out_dtype)
    return (x32 + _mm(attn, w_blk[:, 3 * d:4 * d])
            + s_blk[3, :d]).to(out_dtype)


def _ln_rows(x32, s_blk, d, eps):
    return _layernorm_f32(x32, s_blk[0, :d], s_blk[1, :d], eps)


def _encoder_plain(x, w_packed, s_packed, *, num_heads, valid_len, eps):
    """The per-item kernel's encoder steps on a ``[B, Tp, D]`` stream."""
    cdt = x.dtype
    d = x.shape[-1]
    for step in range(0, w_packed.shape[0], 3):
        x = _attn_sublayer_plain(x.float(), w_packed[step], s_packed[step],
                                 num_heads=num_heads, valid_len=valid_len,
                                 eps=eps, out_dtype=cdt)
        x32 = x.float()
        s1, w2, s2 = s_packed[step + 1], w_packed[step + 2], s_packed[step + 2]
        xn = _ln_rows(x32, s1, d, eps).to(cdt)
        h = gelu(_mm(xn, w_packed[step + 1]) + s1[2], approximate=True
                 ).to(cdt)
        acc = x32 + s2[0, :d]
        for c in range(w2.shape[1] // d):
            cols = slice(c * d, (c + 1) * d)
            acc = acc + _mm(h[..., cols], w2[:, cols])
        x = acc.to(cdt)
    return x


def encoder_forward_lowlat_plain(xp, w_packed, s_packed, *, num_heads: int,
                                 valid_len: int, eps: float = 1e-6):
    """Plain PyTorch version of the encoder-only kernel."""
    with exact_f32_matmul():
        return _encoder_plain(xp, w_packed, s_packed, num_heads=num_heads,
                              valid_len=valid_len, eps=eps)


def _head_logits_plain(cls, s_end, w_end, *, d, hh, eps, head_eps, cdt):
    """Final LN on the CLS rows ``[B, D]`` (f32), a round trip through
    ``cdt``, head LN, fc1 against the f32-upcast weights, erf GELU rounded
    to ``cdt``, and the two fc2 dot products -> logits ``[B, 2]``."""
    f = _layernorm_f32(cls, s_end[0, :d], s_end[1, :d], eps)
    f = f.to(cdt).float()
    f = _layernorm_f32(f, s_end[0, d:2 * d], s_end[1, d:2 * d], head_eps)
    h1 = _mm(f, w_end[:, d:d + hh]) + s_end[2, :hh]
    h1 = 0.5 * h1 * (1.0 + torch.erf(h1 * math.sqrt(0.5)))
    h1 = h1.to(cdt).float()
    l0 = (h1 * s_end[0, 2 * d:2 * d + hh]).sum(-1) + s_end[3, 0]
    l1 = (h1 * s_end[1, 2 * d:2 * d + hh]).sum(-1) + s_end[3, 1]
    return torch.stack([l0, l1], dim=-1)


def forward_lowlat_e2e_plain(xp, w_packed, s_packed, w_end, s_end, aux, *,
                             num_heads: int, eps: float = 1e-6,
                             head_eps: float = 1e-5, valid_len: int):
    """Plain PyTorch version of the fold-ends kernel: the embed GEMM plus
    ``aux`` rounded once, the encoder, the head -> f32 logits ``[B, 2]``."""
    cdt = xp.dtype
    d = xp.shape[-1]
    hh = w_end.shape[2] - d
    with exact_f32_matmul():
        x = (_mm(xp, w_end[0, :, :d]) + aux[0]).to(cdt)
        x = _encoder_plain(x, w_packed, s_packed, num_heads=num_heads,
                           valid_len=valid_len, eps=eps)
        return _head_logits_plain(x[:, 0].float(), s_end[0], w_end[0], d=d,
                                  hh=hh, eps=eps, head_eps=head_eps, cdt=cdt)


def _half_mlp_plain(xn, w_blk, s_blk, d, cdt):
    """``gelu(xn @ fc1 half) @ fc2 half`` of one batch-grid MLP step ->
    the f32 partial MLP output."""
    h = gelu(_mm(xn.to(cdt), w_blk[:, :2 * d]) + s_blk[2, :2 * d],
             approximate=True).to(cdt)
    return (_mm(h[..., :d], w_blk[:, 2 * d:3 * d])
            + _mm(h[..., d:], w_blk[:, 3 * d:]))


def encoder_forward_lowlat_batchgrid_plain(xp, w_packed, s_packed, *,
                                           num_heads: int, valid_len: int,
                                           eps: float = 1e-6):
    """Plain PyTorch version of the batch-grid kernel: per layer the
    attention sub-layer, MLP half A into an f32 partial, then
    ``x + (A + B) + b2`` rounded once."""
    cdt = xp.dtype
    d = xp.shape[-1]
    x = xp
    with exact_f32_matmul():
        for step in range(0, w_packed.shape[0], 3):
            x = _attn_sublayer_plain(x.float(), w_packed[step],
                                     s_packed[step], num_heads=num_heads,
                                     valid_len=valid_len, eps=eps,
                                     out_dtype=cdt)
            x32 = x.float()
            sa, sb = s_packed[step + 1], s_packed[step + 2]
            part = _half_mlp_plain(_ln_rows(x32, sa, d, eps),
                                   w_packed[step + 1], sa, d, cdt)
            out = part + _half_mlp_plain(_ln_rows(x32, sb, d, eps),
                                         w_packed[step + 2], sb, d, cdt)
            x = (x32 + out + sb[3, :d]).to(cdt)
    return x


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_encoder_args(xp, w_packed, s_packed, num_heads, valid_len):
    """Raise on what the lowlat kernels do not take; returns
    ``(b, tp, d, depth)``."""
    b, tp, d = xp.shape
    steps = w_packed.shape[0]
    if steps % 3 or steps == 0:
        raise ValueError(f"the pack holds {steps} steps, not 3 per layer")
    if d % num_heads or d // num_heads not in (16, 32, 64):
        raise ValueError(f"the lowlat kernels take a head dim of 16, 32 or "
                         f"64; got D {d} over {num_heads} heads")
    if d % 8 or tp % 8 or not 0 < valid_len <= tp or b < 1:
        raise ValueError(f"the lowlat kernels take D % 8 == 0, Tp % 8 == 0, "
                         f"0 < valid_len <= Tp and B >= 1; got D {d}, Tp "
                         f"{tp}, valid_len {valid_len}, B {b}")
    bf, dev = torch.bfloat16, xp.device
    _require(xp, "x", bf, (b, tp, d), dev)
    _require(w_packed, "w_packed", bf, (steps, d, 4 * d), dev)
    _require(s_packed, "s_packed", torch.float32, (steps, 4, 4 * d), dev)
    return b, tp, d, steps // 3


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _sync_scratch(dev):
    """The grid barrier's words and the split-K scratch of one launch:
    ``(bar [2 + units] int32, splitk [units, 64, 128] f32, units)``, room
    for two split-K units per SM (the grid is at most two blocks an SM at
    the kernels' shared memory)."""
    units = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    bar = torch.empty((2 + units,), dtype=torch.int32, device=dev)
    splitk = torch.empty((units, 64, 128), dtype=torch.float32, device=dev)
    return bar, splitk, units


def trace_slots(depth: int, *, fold_ends: bool = False,
                batch_grid: bool = False) -> int:
    """Timestamps a traced launch writes: the start, the empty barriers
    that time the barrier itself, one per phase (7 a layer, 8 in the
    batch-grid kernel; the stem and the two head phases with fold-ends)."""
    phases = depth * (8 if batch_grid else 7) + (3 if fold_ends else 0)
    return 1 + _TRACE_BARRIERS + phases


_TRACE_BARRIERS = 4        # kTraceBarriers of csrc/lowlat_core.cuh


def _trace_ptr(trace, need: int, dev):
    if trace is None:
        return None
    _require(trace, "trace", torch.int64, (trace.numel(),), dev)
    if trace.numel() < need:
        raise ValueError(f"trace holds {trace.numel()} stamps; the launch "
                         f"writes {need}")
    return trace.data_ptr()


def _launch_encoder(x_in, w_packed, s_packed, ends, *, num_heads,
                    valid_len, eps, head_eps, trace=None):
    """One launch of ``csrc/lowlat_encoder.cu``: ``ends`` is ``None``
    (encoder-only: returns the stream) or ``(w_end, s_end, aux)``
    (fold-ends: returns the logits)."""
    b, tp, d, depth = _check_encoder_args(x_in, w_packed, s_packed,
                                          num_heads, valid_len)
    dev, bf, f32 = x_in.device, torch.bfloat16, torch.float32
    hh = 0
    if ends is not None:
        w_end, s_end, aux = ends
        hh = w_end.shape[-1] - d
        if hh <= 0 or hh % 8 or 2 * d + hh > 4 * d:
            raise ValueError(f"the fold-ends kernel takes a head width that "
                             f"is a multiple of 8 with 2D + Hh <= 4D; got "
                             f"Hh {hh} at D {d}")
        _require(w_end, "w_end", bf, (1, d, d + hh), dev)
        _require(s_end, "s_end", f32, (1, 4, 4 * d), dev)
        _require(aux, "aux", f32, (1, tp, d), dev)
    rows = b * tp
    x = torch.empty((b, tp, d), dtype=bf, device=dev)
    xn = torch.empty((rows, d), dtype=bf, device=dev)
    qkv = torch.empty((rows, 3 * d), dtype=bf, device=dev)
    hid = torch.empty((rows, 4 * d), dtype=bf, device=dev)
    h1 = torch.empty((b, max(hh, 1)), dtype=f32, device=dev)
    logits = torch.empty((b, 2), dtype=f32, device=dev)
    bar, splitk, units = _sync_scratch(dev)
    end_ptrs = ([t.data_ptr() for t in ends] if ends is not None
                else [None, None, None])
    tr = _trace_ptr(trace, trace_slots(depth, fold_ends=ends is not None), dev)
    lib, fn = _entry("lowlat_encoder")
    err = fn(x_in.data_ptr(), x.data_ptr(), w_packed.data_ptr(),
             s_packed.data_ptr(), *end_ptrs, xn.data_ptr(), qkv.data_ptr(),
             hid.data_ptr(), h1.data_ptr(), logits.data_ptr(), bar.data_ptr(),
             splitk.data_ptr(), units, tr, depth, b, tp, d, num_heads,
             valid_len, hh, eps, head_eps, float(d // num_heads) ** -0.5,
             _stream(dev))
    _build.check(lib, "lowlat_encoder", err)
    LAUNCHES["lowlat_encoder"] += 1
    return x if ends is None else logits


def _refuse_int8(w_packed):
    if w_packed.dtype == torch.int8:
        raise NotImplementedError(_INT8_TODO)


def encoder_forward_lowlat(xp, w_packed, s_packed, *, num_heads: int,
                           valid_len: int, eps: float = 1e-6, trace=None):
    """Padded residual stream ``[B, Tp, D]`` -> ``[B, Tp, D]`` through the
    whole per-item pack in one launch.

    On the card: bf16 stream and W, f32 S, a head dim of 16, 32 or 64,
    D and Tp multiples of 8.  ``trace`` (measurement only): an int64
    tensor of at least :func:`trace_slots` elements on the card that
    receives a global-timer stamp (ns) at each grid barrier."""
    _refuse_int8(w_packed)
    if xp.device.type == "cpu":
        return encoder_forward_lowlat_plain(
            xp, w_packed, s_packed, num_heads=num_heads,
            valid_len=valid_len, eps=eps)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    return _launch_encoder(xp, w_packed, s_packed, None,
                           num_heads=num_heads, valid_len=valid_len,
                           eps=eps, head_eps=0.0, trace=trace)


def forward_lowlat_e2e(xp, w_packed, s_packed, w_end, s_end, aux, *,
                       num_heads: int, eps: float = 1e-6,
                       head_eps: float = 1e-5, valid_len: int, trace=None):
    """Patch rows ``[B, Tp, D]`` (row 0 zeros for the CLS slot, tail rows
    zero padding) -> anti-spoof logits ``[B, 2]`` f32: patch-embed, every
    layer, final LN and the head in one launch.  ``w_end``/``s_end``/
    ``aux`` come from :func:`pack_end_weights`; ``trace`` as in
    :func:`encoder_forward_lowlat`."""
    _refuse_int8(w_packed)
    if xp.device.type == "cpu":
        return forward_lowlat_e2e_plain(
            xp, w_packed, s_packed, w_end, s_end, aux, num_heads=num_heads,
            eps=eps, head_eps=head_eps, valid_len=valid_len)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    return _launch_encoder(xp, w_packed, s_packed, (w_end, s_end, aux),
                           num_heads=num_heads, valid_len=valid_len,
                           eps=eps, head_eps=head_eps, trace=trace)


def encoder_forward_lowlat_batchgrid(xp, w_packed, s_packed, *,
                                     num_heads: int, valid_len: int,
                                     eps: float = 1e-6, trace=None):
    """``[b, Tp, D]`` embedded stream (``b <= 4``) -> the encoder's output,
    every superblock of the batch-grid pack read once for the whole
    chunk, in one launch.  The serving wrapper chunks larger batches.
    ``trace`` as in :func:`encoder_forward_lowlat`."""
    b = xp.shape[0]
    if b > 4:
        raise ValueError(f"batch-grid kernel holds <= 4 residual "
                         f"streams in VMEM (got {b}); chunk the batch")
    if w_packed.dtype == torch.int8 or s_packed.shape[1] != 4:
        raise ValueError(
            "batch-grid packs must be full-precision (got "
            f"{w_packed.dtype} / {s_packed.shape[1]} S rows) — int8 "
            "weight streaming is the per-item lowlat flavor "
            "(prepare_lowlat(int8_weights=True))")
    if xp.device.type == "cpu":
        return encoder_forward_lowlat_batchgrid_plain(
            xp, w_packed, s_packed, num_heads=num_heads,
            valid_len=valid_len, eps=eps)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    b, tp, d, depth = _check_encoder_args(xp, w_packed, s_packed, num_heads,
                                          valid_len)
    dev, bf = xp.device, torch.bfloat16
    rows = b * tp
    x = torch.empty((b, tp, d), dtype=bf, device=dev)
    xn = torch.empty((rows, d), dtype=bf, device=dev)
    qkv = torch.empty((rows, 3 * d), dtype=bf, device=dev)
    hid = torch.empty((rows, 4 * d), dtype=bf, device=dev)
    part = torch.empty((rows, d), dtype=torch.float32, device=dev)
    bar, splitk, units = _sync_scratch(dev)
    tr = _trace_ptr(trace, trace_slots(depth, batch_grid=True), dev)
    lib, fn = _entry("lowlat_batchgrid")
    err = fn(xp.data_ptr(), x.data_ptr(), w_packed.data_ptr(),
             s_packed.data_ptr(), xn.data_ptr(), qkv.data_ptr(),
             hid.data_ptr(), part.data_ptr(), bar.data_ptr(),
             splitk.data_ptr(), units, tr, depth, b, tp,
             d, num_heads, valid_len, eps, float(d // num_heads) ** -0.5,
             _stream(dev))
    _build.check(lib, "lowlat_batchgrid", err)
    LAUNCHES["lowlat_batchgrid"] += 1
    return x
