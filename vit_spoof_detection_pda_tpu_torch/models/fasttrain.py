"""Training forward of ``ViTAntiSpoof`` over the hand-written kernels
(counterpart of the JAX package's ``models/fasttrain.py``).

Per encoder layer:

- :class:`AttnBlockTrain`: the attention sub-layer.  Its forward is the
  training attention-block kernel (``csrc/attention_block_train.cu``),
  which also writes the backward's residuals (``qkv``, the head outputs,
  the LN's ``xhat`` and ``inv``) padded to Tp = 200 rows; its backward
  runs the weight-grad GEMMs and ``dxn`` as ``torch`` products (XLA's in
  the JAX package), then the attention-backward kernel
  (``csrc/attention_qkv_bwd.cu``) and the LN/residual-backward kernel
  (``csrc/ln_res_bwd.cu``).  With grad off it runs the serving kernel.
- :class:`MlpBlockTrainH`: the MLP sub-layer with the stored-hidden
  backward: ``torch`` products, and the LN/residual-backward kernel for
  its tail (``mlp_mode="hidden"``, the default).
- :class:`MlpBlockTrainP`: the same backward under the training MLP
  kernel's forward (``csrc/mlp_block_train.cu``, ``mlp_mode="fused"``).
- :class:`MlpBlockTrainX`: the recompute-hidden backward that keeps only
  ``x`` and ``xhat`` (``mlp_mode="xhat"``; plain ops, no kernel).
- ``mlp_mode="autodiff"``: plain differentiable ops.

Every kernel takes bf16 or f32 (``compute_dtype``); f32 runs their f32
forms, never TF32.

Products in the compute dtype go through :func:`_mm32`: an f32 result of
the compute-dtype operands, as JAX's ``preferred_element_type=float32``
dots give, then the bias in f32 and one rounding.  The stream between
layers is ``[B, 197, D]``, as in JAX: the attention block pads it to 200
rows and slices the output back.

:func:`train_forward` is the functional ``ViTAntiSpoof`` forward over
the JAX-layout parameter tree (tensors), with head dropout driven by an
explicit ``torch.Generator``; :func:`make_apply` wraps it as the
model's apply function.  Entry points take the device of the tensors
they are given; the CPU runs every kernel's plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import exact_f32_matmul
from ..ops.attention import (_round_up, attention_block_train_padded,
                             attention_qkv_bwd, fused_attention_block,
                             mlp_block_train)
from ..ops.gelu import gelu as _gelu
from ..ops.gelu import gelu_lean
from ..ops.ln_bwd import ln_residual_bwd
from ..utils.profiling import annotate
from .fastserve import embed_patches

MLP_MODES = ("hidden", "autodiff", "xhat", "fused")


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ b`` of 2-D operands in one dtype: exact products, f32
    sums.  On the card a bf16 product runs on the tensor cores with an f32
    result; f32 operands and the CPU use f32 matmul with TF32 off."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    with exact_f32_matmul():
        return torch.matmul(a.float(), b.float())


class _Mm32(torch.autograd.Function):
    """:func:`_mm32` for the differentiable parts of the forward (the head,
    the "autodiff" MLP): the cotangents are f32 products rounded to the
    operands' dtypes, as the transpose of JAX's f32-result dot gives
    them (``torch.mm`` with an f32 result has no derivative of its own)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with exact_f32_matmul():
            ga = torch.matmul(g, b.float().t()).to(a.dtype)
            gb = torch.matmul(a.float().t(), g).to(b.dtype)
        return ga, gb


def _ln_xhat_inv(x, scale, bias, eps: float):
    """f32 LayerNorm: ``(xhat, xhat * scale + bias, inv)``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    inv = torch.rsqrt(((x32 - mu) ** 2).mean(-1, keepdim=True) + eps)
    xh = (x32 - mu) * inv
    return xh, xh * scale.float() + bias.float(), inv


def _ln_forward(x, scale, bias, eps: float):
    return _ln_xhat_inv(x, scale, bias, eps)[1]


# --------------------------------------------------------------------------
# Attention sub-layer
# --------------------------------------------------------------------------


def attn_block_train_fwd(x, lns, lnb, wqkv, bqkv, wproj, bproj,
                         num_heads: int, eps: float):
    """``x [B, T, D]`` -> ``(o [B, T, D], qkv [B, Tp, 3D], attn [B, Tp, D],
    xh [B, Tp, D], inv [B, Tp, 1])``, Tp = T rounded up to 8: the
    counterpart of ``_attn_block_fwd_pallas``.  The residuals stay padded;
    the pad rows hold the LN of a zero row, and the backward gives them a
    zero cotangent."""
    b, t, d = x.shape
    xp = F.pad(x, (0, 0, 0, _round_up(t, 8) - t))
    o, qkv, attn, xh, inv = attention_block_train_padded(
        xp, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads, valid_len=t,
        eps=eps)
    return o[:, :t], qkv, attn, xh, inv


class AttnBlockTrain(torch.autograd.Function):
    """``x + proj(attention(LN1(x) @ Wqkv + bqkv)) + bproj`` with the
    training kernel's forward and a backward that recomputes nothing but
    the softmax (the JAX ``attn_block_train``: ``_abt_fwd`` / ``_abt_bwd``).
    Weights in the compute dtype, LN vectors and biases f32."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads, eps):
        o, qkv, attn, xh, inv = attn_block_train_fwd(
            x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads, eps)
        ctx.save_for_backward(qkv, attn, xh, inv, lns, lnb, wqkv, wproj)
        ctx.num_heads, ctx.t = num_heads, x.shape[1]
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, attn, xh, inv, lns, lnb, wqkv, wproj = ctx.saved_tensors
        b, tp, d = attn.shape
        t, cdt = ctx.t, qkv.dtype
        # the products run over the padded rows: g is zero there, so they
        # add nothing, and dqkv comes out zero on them
        g_p = F.pad(g.to(cdt), (0, 0, 0, tp - t)).reshape(b * tp, d)
        dbproj = g.sum((0, 1), dtype=torch.float32)
        dwproj = _mm32(attn.reshape(-1, d).t(), g_p).to(wproj.dtype)
        dattn = _mm32(g_p, wproj.t()).to(cdt).view(b, tp, d)
        dqkv = attention_qkv_bwd(qkv, dattn, ctx.num_heads,
                                 valid_len=t).view(b * tp, 3 * d)
        xn = (xh.float() * lns + lnb).to(cdt).view(b * tp, d)
        dwqkv = _mm32(xn.t(), dqkv).to(wqkv.dtype)
        dbqkv = dqkv.sum(0, dtype=torch.float32)
        dxn = _mm32(dqkv, wqkv.t()).to(cdt).view(b, tp, d)
        dx, dlns, dlnb = ln_residual_bwd(xh, inv, dxn, g_p.view(b, tp, d),
                                         lns)
        return (dx[:, :t], dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj, None,
                None)


def attn_block_train(x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads: int,
                     eps: float):
    """The attention sub-layer for training.  With grad off (eval) it
    runs the serving kernel, as the JAX primal does: same math, one
    output, none of the residuals' writes."""
    args = (x, lns, lnb, wqkv, bqkv, wproj, bproj)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return AttnBlockTrain.apply(*args, num_heads, eps)
    return fused_attention_block(*args, num_heads, eps=eps)


# --------------------------------------------------------------------------
# MLP sub-layer, stored-hidden backward
# --------------------------------------------------------------------------


def _gelu_mode(approx: bool) -> str:
    return "tanh" if approx else "none"


def _mlp_fwd(x, lns, lnb, w1, b1, w2, b2, approx: bool, eps: float):
    """``(y, xhat, inv, h)`` of ``x + fc2(gelu(fc1(LN2(x))))``: the hidden
    ``h`` rounded to the compute dtype before the GELU, the GELU output
    rounded again, ``x + fc2 + b2`` summed in f32 and rounded once.  The
    GELU and its derivative are PyTorch's fused ``gelu`` and
    ``gelu_backward`` (one pass each, f32 inside, rounded once to the
    compute dtype): the same formulas as ``jax.nn.gelu``, written with
    ``1 + erf`` where JAX writes ``erfc``, a difference of f32 ulps."""
    b, t, d = x.shape
    cdt = x.dtype
    xh, yn, inv = _ln_xhat_inv(x, lns, lnb, eps)
    h = (_mm32(yn.to(cdt).reshape(-1, d), w1) + b1.float()).to(cdt)
    a = F.gelu(h, approximate=_gelu_mode(approx))
    out = _mm32(a, w2) + b2.float()
    y = (x.float() + out.view(b, t, d)).to(cdt)
    return y, xh, inv, h


class MlpBlockTrainH(torch.autograd.Function):
    """``x + fc2(gelu(fc1(LN2(x))))`` keeping ``(xhat, inv, h)`` for the
    backward, which recomputes the GELU gate elementwise and ends in the
    LN/residual-backward kernel (the JAX ``mlp_block_train_h``:
    ``_mbh_fwd`` / ``_mbh_bwd``)."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w1, b1, w2, b2, approx, eps):
        y, xh, inv, h = _mlp_fwd(x, lns, lnb, w1, b1, w2, b2, approx, eps)
        ctx.save_for_backward(xh.to(x.dtype), inv, h, lns, lnb, w1, w2)
        ctx.approx = approx
        return y

    @staticmethod
    def backward(ctx, g):
        xh, inv, h, lns, lnb, w1, w2 = ctx.saved_tensors
        b, t, d = xh.shape
        cdt = h.dtype
        gc = g.to(cdt).reshape(b * t, d)
        mode = _gelu_mode(ctx.approx)
        a = F.gelu(h, approximate=mode)
        da = _mm32(gc, w2.t()).to(cdt)
        dw2 = _mm32(a.t(), gc).to(w2.dtype)
        db2 = g.sum((0, 1), dtype=torch.float32)
        dh = torch.ops.aten.gelu_backward(da, h, approximate=mode)
        xn = (xh.float() * lns + lnb).to(cdt).view(b * t, d)
        dw1 = _mm32(xn.t(), dh).to(w1.dtype)
        db1 = dh.sum(0, dtype=torch.float32)
        dxn = _mm32(dh, w1.t()).to(cdt).view(b, t, d)
        dx, dlns, dlnb = ln_residual_bwd(xh, inv, dxn, gc.view(b, t, d), lns)
        return dx, dlns, dlnb, dw1, db1, dw2, db2, None, None


def mlp_block_train_h(x, lns, lnb, w1, b1, w2, b2, approx: bool,
                      eps: float):
    return MlpBlockTrainH.apply(x, lns, lnb, w1, b1, w2, b2, approx, eps)


class MlpBlockTrainP(MlpBlockTrainH):
    """:class:`MlpBlockTrainH` with the whole forward as the training MLP
    kernel (kernel 7) over the flat ``B*T`` rows, which writes the same
    residuals (``xhat``, ``inv``, ``h``); the backward is the stored-hidden
    one (the JAX ``mlp_block_train_p``: ``_mbp_fwd`` / ``_mbp_bwd``).  The
    kernel's GELU is exact erf where the TPU kernel emulated it, so the
    forward and the backward's gate recompute agree."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w1, b1, w2, b2, approx, eps):
        b, t, d = x.shape
        y, xh, inv, h = mlp_block_train(
            x.reshape(b * t, d), lns, lnb, w1, b1, w2, b2,
            approximate=approx, eps=eps)
        ctx.save_for_backward(xh.view(b, t, d), inv.view(b, t, 1), h, lns,
                              lnb, w1, w2)
        ctx.approx = approx
        return y.view(b, t, d)


def mlp_block_train_p(x, lns, lnb, w1, b1, w2, b2, approx: bool,
                      eps: float):
    return MlpBlockTrainP.apply(x, lns, lnb, w1, b1, w2, b2, approx, eps)


class MlpBlockTrainX(torch.autograd.Function):
    """``x + fc2(gelu(fc1(LN2(x))))`` keeping only ``x`` and ``xhat``: the
    backward rebuilds the hidden with one more product instead of reading
    it back (the JAX ``mlp_block_train``: ``_mbt_fwd`` / ``_mbt_bwd``, the
    memory-lean mode).  Its LayerNorm tail is plain f32 ops on the
    recomputed ``inv``, as JAX's is (no kernel)."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w1, b1, w2, b2, approx, eps):
        y, xh, _, _ = _mlp_fwd(x, lns, lnb, w1, b1, w2, b2, approx, eps)
        ctx.save_for_backward(x, xh.to(x.dtype), lns, lnb, w1, b1, w2)
        ctx.approx, ctx.eps = approx, eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, xh, lns, lnb, w1, b1, w2 = ctx.saved_tensors
        b, t, d = x.shape
        cdt = x.dtype
        mode = _gelu_mode(ctx.approx)
        g32 = g.float()
        gc = g.to(cdt).reshape(b * t, d)
        xh32 = xh.float()
        xn = (xh32 * lns + lnb).to(cdt).view(b * t, d)
        h = (_mm32(xn, w1) + b1.float()).to(cdt)              # the recompute
        a = F.gelu(h, approximate=mode)
        da = _mm32(gc, w2.t()).to(cdt)
        dw2 = _mm32(a.t(), gc).to(w2.dtype)
        db2 = g32.sum((0, 1))
        dh = torch.ops.aten.gelu_backward(da, h, approximate=mode)
        dw1 = _mm32(xn.t(), dh).to(w1.dtype)
        db1 = dh.sum(0, dtype=torch.float32)
        dxn = _mm32(dh, w1.t()).view(b, t, d)                 # f32
        dlns = (dxn * xh32).sum((0, 1))
        dlnb = dxn.sum((0, 1))
        dxh = dxn * lns
        x32 = x.float()
        inv = torch.rsqrt(x32.var(-1, unbiased=False, keepdim=True)
                          + ctx.eps)
        dx_ln = inv * (dxh - dxh.mean(-1, keepdim=True)
                       - xh32 * (dxh * xh32).mean(-1, keepdim=True))
        dx = (g32 + dx_ln).to(cdt)
        return dx, dlns, dlnb, dw1, db1, dw2, db2, None, None


def mlp_block_train_x(x, lns, lnb, w1, b1, w2, b2, approx: bool,
                      eps: float):
    return MlpBlockTrainX.apply(x, lns, lnb, w1, b1, w2, b2, approx, eps)


def _mlp_autodiff(x, lns, lnb, w1, b1, w2, b2, approx: bool, eps: float):
    """The MLP sub-layer as plain differentiable ops, the GELU through
    :func:`gelu_lean` (the JAX ``"autodiff"`` mode)."""
    b, t, d = x.shape
    cdt = x.dtype
    yn = _ln_forward(x, lns, lnb, eps).to(cdt).reshape(-1, d)
    h = (_Mm32.apply(yn, w1) + b1.float()).to(cdt)
    a = gelu_lean(h, approx)
    out = _Mm32.apply(a, w2) + b2.float()
    return (x.float() + out.view(b, t, d)).to(cdt)


# --------------------------------------------------------------------------
# Functional ViTAntiSpoof forward
# --------------------------------------------------------------------------


def _dropout(generator, x, rate: float, train: bool):
    """Inverted dropout with an explicit generator: keep with probability
    ``1 - rate`` and scale the kept values by ``1 / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def train_forward(params, batch, *, generator=None, train: bool = False,
                  num_heads: int = 12, patch_size: int = 16, depth: int = 12,
                  norm_eps: float = 1e-6, dtype=torch.bfloat16,
                  gelu: str = "erf", dropout: float = 0.1,
                  mlp_mode: str = "hidden") -> torch.Tensor:
    """``ViTAntiSpoof`` forward as a function -> f32 logits ``[B, 2]``,
    differentiable in every leaf of ``params`` (the JAX-layout tree of
    tensors; matrices are cast to ``dtype`` here, LN vectors and biases
    stay f32).  ``batch``: normalized f32 images ``[B, H, W, 3]`` on the
    parameters' device.

    ``mlp_mode``: "hidden" (stored-hidden backward with the LN-tail
    kernel; the default), "fused" (the same backward under the training
    MLP kernel's forward), "xhat" (recompute-hidden backward, keeps only
    ``x`` and ``xhat``) or "autodiff" (plain ops, lean GELU).
    ``train=True`` with ``dropout > 0`` needs ``generator``."""
    if mlp_mode not in MLP_MODES:
        raise ValueError(f"unknown mlp_mode {mlp_mode!r} (expected "
                         f"{' | '.join(MLP_MODES)})")
    if train and generator is None and dropout > 0.0:
        raise ValueError("train=True with dropout > 0 requires a dropout "
                         "generator")
    vit = params["vit"]
    x = embed_patches(vit, batch, dtype=dtype, patch_size=patch_size)
    approx = gelu == "tanh"
    mlp = {"hidden": mlp_block_train_h, "fused": mlp_block_train_p,
           "xhat": mlp_block_train_x, "autodiff": _mlp_autodiff}[mlp_mode]
    for i in range(depth):
        blk = vit[f"block{i}"]
        at, ml = blk["attn"], blk["mlp"]
        x = attn_block_train(
            x, blk["norm1"]["scale"], blk["norm1"]["bias"],
            at["qkv"]["kernel"].to(dtype), at["qkv"]["bias"],
            at["proj"]["kernel"].to(dtype), at["proj"]["bias"],
            num_heads, norm_eps)
        x = mlp(x, blk["norm2"]["scale"], blk["norm2"]["bias"],
                ml["fc1"]["kernel"].to(dtype), ml["fc1"]["bias"],
                ml["fc2"]["kernel"].to(dtype), ml["fc2"]["bias"],
                approx, norm_eps)

    # the final LN is row-local: the CLS row alone gives the same features
    feats = _ln_forward(x[:, 0], vit["norm"]["scale"], vit["norm"]["bias"],
                        norm_eps)                            # f32 [B, D]
    head = params["head"]
    drop = train and generator is not None
    f = _ln_forward(feats, head["norm"]["scale"], head["norm"]["bias"], 1e-5)
    f = _dropout(generator, f.to(dtype), dropout, drop)
    f = _Mm32.apply(f, head["fc1"]["kernel"].to(dtype)) + head["fc1"]["bias"]
    f = _gelu(f, approximate=False)                          # head keeps erf
    f = _dropout(generator, f.to(dtype), dropout, drop)
    with exact_f32_matmul():
        return (torch.matmul(f.float(), head["fc2"]["kernel"].float())
                + head["fc2"]["bias"])


def fast_apply_available(module, mesh=None) -> bool:
    """The fused training forward applies to the port's ``ViTAntiSpoof``
    on one rank (JAX :822): a mesh of more than one rank keeps the module
    path, whose attention dispatch knows the mesh."""
    from .vit import ViTAntiSpoof
    return isinstance(module, ViTAntiSpoof) and (mesh is None
                                                 or mesh.size() == 1)


def make_apply(module, *, dtype=None, mlp_mode: str = "hidden"):
    """``apply_fn(variables, batch, *, train=False, generator=None)`` over
    :func:`train_forward` for the port's ``ViTAntiSpoof`` (its geometry,
    GELU and dropout rate), computing in ``dtype``: the module's own
    ``dtype`` unless given, as JAX's ``make_apply`` reads
    ``module.dtype``.  ``mlp_mode`` as :func:`train_forward`.  There is
    no module-path fallback: on the card the kernels are the path.  Runs
    in the span ``vsd.build.train_apply``."""
    with annotate("vsd.build.train_apply"):
        if not fast_apply_available(module):
            raise TypeError(f"make_apply takes the port's ViTAntiSpoof; "
                            f"got {type(module).__name__}")
        if dtype is None:
            dtype = module.dtype
        if mlp_mode not in MLP_MODES:
            raise ValueError(f"unknown mlp_mode {mlp_mode!r} (expected "
                             f"{' | '.join(MLP_MODES)})")
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute dtype {dtype} (bfloat16 | float32)")

    def apply_fn(variables, batch, *, train: bool = False, generator=None):
        return train_forward(
            variables["params"], batch, generator=generator, train=train,
            num_heads=module.num_heads, patch_size=module.patch_size,
            depth=module.depth, norm_eps=module.norm_eps, dtype=dtype,
            gelu=module.gelu, dropout=module.dropout, mlp_mode=mlp_mode)

    return apply_fn
