"""The kernels of several checkouts, timed in turns on one card, each
beside the PyTorch call that computes the same function:

- kernel 4 (``attention_qkv_bwd``) and kernel 5 (``attention_qkv_bwd_phased``)
  at the fasttrain step's shape (ViT-B/16: B 128, Tp 200, D 768, 12 heads,
  197 valid rows; f32 at B 32), beside the backward of
  ``scaled_dot_product_attention`` with the same key mask;
- kernel 12 (``fused_attention_qkv_cp``) and kernel 13
  (``attention_cp_bwd``) at the 2-rank sequence-parallel step's block
  (B 128, Tq 104, Tk 208, 197 valid keys; their f32 forms at B 32),
  beside ``scaled_dot_product_attention`` on the 197 real keys (the masked
  keys add exactly 0) and its backward;
- kernels 8 (``fused_attention_qkv``) and 9 (``fused_attention`` on the
  strided q/k/v views of one ``[B, T, 3D]``, as the int8 path passes
  them) at the module path's shape (B 128, T 197; f32 at B 32), beside
  SDPA on the same views, and ``..._cp_self``: kernel 12 at Tq = Tk = T
  (the same function on its own core);
- the same three at B 8 past kernel 12's one-pass keys: T 257, 325 and
  577 (ViT-B/16 at 256, 288 and 384 px) and 1025 (512 px), bf16 and f32
  (``..._<T>[_f32]``): kernel 12 there runs its two-pass form (K and V
  whole where they fit, else key tiles);
- the training step around kernel 4 (``train_step_bf16`` at B 128,
  ``train_step_f32`` at B 32: ``make_train_step`` over
  ``fasttrain.make_apply``, 12 launches of kernel 4 a step);
- every route of the backward at the main shapes: the key-tiled backward
  forced where kernels 4, 5 and 13 run their own (``..._kt``), kernel 13
  at the 4-rank block (Tq 56, Tk 224; ``attention_cp_bwd_sp4[_kt]``), and
  kernels 4 and 5 and the forced key tiles at f32 Tp 264 (``..._264_f32``)
  and at f32 head dims 48 and 128 (``..._dh48_f32``, ``..._dh128_f32``);
- shapes past the one-launch on-chip backward that an older body held:
  kernel 4 at bf16 Tp 224 and head dims 16 and 32
  (``attention_qkv_bwd_224_dh16``, ``..._224_dh32``), kernel 13 at bf16
  Tq 128 / Tk 256 (``attention_cp_bwd_128x256``), and both at f32 head dim
  96 (``attention_qkv_bwd_dh96_f32``, ``attention_cp_bwd_dh96_f32``);
- the module forwards around kernel 8: the `test` verb's bf16
  ``ViTAntiSpoof`` at B 128 and evaluate-all's f32 ``ViTLinearHead`` at
  B 32 (``models/registry.py::build_model`` on seeded random weights);
- kernels 1 and 3 (``fused_attention_block_padded``,
  ``attention_block_train_padded``) at B 128, Tp 200, and kernels 10 and
  11 on random ViT-B/16 packs, with no library call:
  ``encoder_forward_lowlat`` at B 1 (``lowlat_encoder``; on the int8 pack
  ``lowlat_encoder_int8``), ``forward_lowlat_e2e`` at B 1 (``lowlat_e2e``),
  ``..._batchgrid`` per chunk of 2 (``lowlat_batchgrid``) and 4
  (``lowlat_batchgrid_4``);
- the GEMM cores alone (``ops/gemm.py::gemm``, bias epilogue) at
  ViT-B/16's four products, QKV, proj, fc1 and fc2 (``gemm_qkv``,
  ``gemm_proj``, ``gemm_fc1``, ``gemm_fc2``: bf16 at M 25,600 = B 128 x
  Tp 200; ``..._f32`` at M 6,400), and proj and fc2 with the blocks'
  residual epilogue (``gemm_proj_res``, ``gemm_fc2_res``), beside
  ``torch.matmul`` with TF32 off (no epilogue),
  in a tree that has ``vsd_gemm``; the blocks around them: kernel 2
  (``mlp_block``, B 128), kernel 7 (``mlp_block_train``, 25,216 rows; f32
  ``mlp_block_train_f32``, 6,304), kernels 1 and 3 at f32
  (``attention_block_f32``, ``attention_block_train_f32``, B 32), the B 128
  scoring forward (``serving_forward_b128``: ``make_serving_fn`` on
  fastserve) and the default training step (``train_step_bf16_hidden``:
  ``make_apply(mlp_mode="hidden")``, B 128);
- at ViT-B/16, 384 px (B 8, T 577, Tp 584), kernel 5's route past its one
  launch (``..._384``: the four-launch long route before the key-tiled
  backward replaced it, the key-tiled backward after), bf16 and f32, beside
  SDPA's masked backward; and, in a tree that has the key-tiled routes
  (``ops/attention.py::tiled_bwd_plan``), kernel 13's key-tiled instance
  and kernel 12's f32 key tiles at the 2-rank block (Tq 296, Tk 592), and
  at 512 px kernel 12's bf16 key tiles (Tq 520, Tk 1040), beside SDPA;
- kernel 14 (``pool_gather``: the launch alone, B 128 faces of a 4,096-face
  pool, beside ``index_select`` on the same device indices; ``..._cold``
  on 8 sets of distinct rows in turn, past the L2; ``..._wrapper`` with
  the host check and upload, beside the plain version) and kernel 17
  (``doctor_probe`` on the doctor's [8, 128], beside ``torch.mul``);
- kernel 15 (``warp_pass``: a bf16 B 128, 224 x 224 x 3 batch, a full f32
  field at the perspective's kmax 33, along x; ``warp_pass_cols`` the same
  along y; ``warp_pass_rot`` the rotation's per-row shifts, a broadcast
  field, kmax 11; ``warp_pass_f32`` an f32 image, full field, along x), no
  library call;
- kernel 6 (``ln_res_bwd``: bf16 B 128, Tp 200, D 768, bf16 dxn;
  ``ln_res_bwd_f32dxn`` with f32 dxn; ``ln_res_bwd_f32`` the f32 form at
  B 32), beside ``native_layer_norm_backward`` plus the residual add (on
  dxn in the type of xh).

    python tests/torch_kernel_ab.py [--only NAME,...] TREE [TREE ...]

Each TREE is the root of a checkout (a ``git archive`` unpacked into a
directory that ``.gitignore`` lists, or ``.`` for this one); name them in
the order to run, e.g. ``parent . . parent``.  ``--only`` times just the
named runs (the keys of the JSON lines) and builds up front only the
libraries whose names the named runs start with.  For each, one process
imports that tree's port, builds the kernels from its sources (into that
tree's ``build/``), prints ptxas's register and spill report for each
head-dim-64 instantiation of those kernels, and times each kernel and its
library call in turns (kernel, library, library, kernel), each turn 5
windows of at least 20 calls and 2 ms between CUDA events, on
numpy-seeded operands that are the same in every tree.  Prints one JSON line per tree (the medians
over both turns, in ms; each run's and its library call's device time a
call over 10 calls, from torch.profiler; the sums of each output's
magnitudes), then the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys

B, B32, TP, T, D, HEADS = 128, 32, 200, 197, 768, 12
TQ, TK = 104, 208                  # one of two sequence ranks' blocks
B384, T384, TP384 = 8, 577, 584    # ViT-B/16 at 384 px
TQ384, TK384 = 296, 592            # ... one of two sequence ranks' blocks
TQ4, TK4 = 56, 224                 # one of four sequence ranks' blocks
T256, TP256 = 257, 264             # ViT-B/16 at 256 px
T512, TP512 = 1025, 1040           # ViT-B/16 at 512 px
T_PAST = (257, 325, 577, 1025)      # ViT-B/16 at 256, 288, 384, 512 px
NAMES = ("pool_gather", "doctor_probe", "warp_pass", "ln_res_bwd", "gemm", "mlp_block", "mlp_block_train", "attention_block_f32",
         "attention_bwd_onchip", "attention_qkv_bwd", "attention_qkv_bwd_f32",
         "attention_qkv_bwd_phased",
         "attention_qkv_bwd_phased_long",
         "attention_bwd_tiled", "attention_cp", "attention_cp_bwd",
         "attention_qkv", "attention", "attention_block",
         "attention_block_train", "lowlat_encoder", "lowlat_batchgrid")


def _ptxas(log: str) -> list:
    """(kernel, registers, spill line) of each head-dim-64 entry point."""
    out, entry, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1) if any(k in m.group(1) for k in (
                "Li64E", "pool_gather", "doctor_probe", "warp_",
                "ln_res_bwd")) else None
        elif entry and "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif entry and "registers" in ln:
            name = re.sub(r"^_ZN3vsd\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "", entry)
            out.append([name[:48], ln.split("Used")[1].split(",")[0].strip(),
                        spill])
            entry = None
    return out


def _child(tree: str, only=None) -> None:
    import statistics

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from vit_spoof_detection_pda_tpu_torch.device import exact_f32_matmul
    from vit_spoof_detection_pda_tpu_torch.models import registry
    from vit_spoof_detection_pda_tpu_torch.ops import _build
    from vit_spoof_detection_pda_tpu_torch.ops import attention as att
    from vit_spoof_detection_pda_tpu_torch.ops import lowlat as low

    # built up front (ptxas's report): every library, or with --only those
    # the named runs start with; any other a run calls builds at first use
    names = [n for n in NAMES if n in _build.KERNELS
             and (not only or any(o.startswith(n) for o in only))]
    _build.build(names)
    ptxas = {n: _ptxas(_build.build_log(n)) for n in names}
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rand(*shape, dt=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt)

    def sdpa_bwd(qkv, g, tk, valid, heads=HEADS):
        """SDPA's backward on the heads of ``qkv`` (keys past ``valid``
        masked) for the cotangent ``g``."""
        b, tq, d3 = qkv.shape
        q, k, v = (t.contiguous().requires_grad_() for t in qkv.view(
            b, tq, 3, heads, d3 // 3 // heads).permute(2, 0, 3, 1, 4))
        mask = (torch.arange(tk, device=dev) < valid).view(1, 1, 1, tk)
        o = sdpa(q, k, v, attn_mask=mask)
        go = g.view(b, tq, heads, -1).transpose(1, 2)
        return lambda: torch.autograd.grad(o, (q, k, v), go,
                                           retain_graph=True)

    def kt_qkv(qkv, g, heads, valid):
        """The key-tiled backward (``csrc/attention_bwd_tiled.cu``) forced
        on the fused projection, whatever the plan would choose."""
        b, tp, d3 = qkv.shape
        d = d3 // 3
        dqkv = torch.empty_like(qkv)
        p, o, es = qkv.data_ptr(), dqkv.data_ptr(), qkv.element_size()
        att._launch_bwd_tiled(
            "attention_bwd_tiled" + ("_f32" if g.dtype == torch.float32
                                     else ""),
            p, p + d * es, p + 2 * d * es, g, o, o + d * es, o + 2 * d * es,
            batch=b, heads=heads, dh=d // heads, tq=tp, tk=tp, ldq=d3,
            ldk=d3, ldg=d, bsq=tp * d3, bsk=tp * d3, bsg=tp * d,
            valid_len=valid)
        return dqkv

    def kt_cp(q, kv, g, valid, heads=HEADS):
        """The key-tiled backward forced on kernel 13's rectangle."""
        b, tq, d = q.shape
        tk = kv.shape[1]
        dq, dkv = torch.empty_like(q), torch.empty_like(kv)
        es, pk, pd = q.element_size(), kv.data_ptr(), dkv.data_ptr()
        att._launch_bwd_tiled(
            "attention_cp_bwd_tiled" + ("_f32" if g.dtype == torch.float32
                                        else ""),
            q.data_ptr(), pk, pk + d * es, g, dq.data_ptr(), pd, pd + d * es,
            batch=b, heads=heads, dh=d // heads, tq=tq, tk=tk, ldq=d,
            ldk=2 * d, ldg=d, bsq=tq * d, bsk=tk * 2 * d, bsg=tq * d,
            valid_len=valid)
        return dq, dkv

    def cp_runs(name, b, tq, tk, valid, dt, bwd, kt=False, heads=HEADS):
        """Kernel 12 (or 13 with ``bwd``; with ``kt`` the key-tiled
        backward forced on the same block) on a (tq, tk) block beside SDPA
        (its backward) on the ``valid`` real keys."""
        q, kv = rand(b, tq, D, dt=dt), rand(b, tk, 2 * D, dt=dt)
        qh = q.view(b, tq, heads, -1).transpose(1, 2).contiguous()
        kh, vh = (t.view(b, tk, heads, -1).transpose(1, 2)[:, :, :valid]
                  .contiguous() for t in kv.split(D, -1))
        if not bwd:
            runs[name] = (
                lambda: att.fused_attention_qkv_cp(q, kv, HEADS, valid),
                lambda: sdpa(qh, kh, vh))
            return
        gq = rand(b, tq, D, dt=dt)
        qg, kg, vg = (t.requires_grad_() for t in (qh, kh, vh))
        o = sdpa(qg, kg, vg)
        go = gq.view(b, tq, heads, -1).transpose(1, 2)
        runs[name] = (
            (lambda: kt_cp(q, kv, gq, valid, heads)) if kt else
            (lambda: att.attention_cp_bwd(q, kv, gq, heads, valid)),
            lambda: torch.autograd.grad(o, (qg, kg, vg), go,
                                        retain_graph=True))

    def module_runs(sfx, b, t, dt):
        """Kernels 8 and 9 on one [B, T, 3D] projection (9 on its strided
        q/k/v views) and kernel 12 at Tq = Tk = T, each beside SDPA."""
        qkv = rand(b, t, 3 * D, dt=dt)
        q, k, v = qkv.view(b, t, 3, HEADS, -1).unbind(2)      # [B,T,H,dh]
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: sdpa(qh, kh, vh)
        runs["attention_qkv" + sfx] = (
            lambda: att.fused_attention_qkv(qkv, HEADS), lib)
        runs["attention" + sfx] = (lambda: att.fused_attention(q, k, v), lib)
        qc, kv = rand(b, t, D, dt=dt), rand(b, t, 2 * D, dt=dt)
        qch = qc.view(b, t, HEADS, -1).transpose(1, 2)
        kch, vch = (x.view(b, t, HEADS, -1).transpose(1, 2)
                    for x in kv.split(D, -1))
        runs["attention_cp_self" + sfx] = (
            lambda: att.fused_attention_qkv_cp(qc, kv, HEADS, t),
            lambda: sdpa(qch, kch, vch))

    def scaled(*shape, scale, shift=0.0, dt=torch.bfloat16):
        return rand(*shape, dt=torch.float32).mul_(scale).add_(shift).to(dt)

    runs = {}
    for dt, b, sfx in ((torch.bfloat16, B, ""), (torch.float32, B32, "_f32")):
        qkv, g = rand(b, TP, 3 * D, dt=dt), rand(b, TP, D, dt=dt)
        g[:, T:] = 0
        lib = sdpa_bwd(qkv, g, TP, T)
        runs["attention_qkv_bwd" + sfx] = (
            lambda qkv=qkv, g=g: att.attention_qkv_bwd(
                qkv, g, HEADS, valid_len=T), lib)
        runs["attention_qkv_bwd_phased" + sfx] = (
            lambda qkv=qkv, g=g: att.attention_qkv_bwd_phased(
                qkv, g, HEADS, valid_len=T), lib)
        q, kv = rand(b, TQ, D, dt=dt), rand(b, TK, 2 * D, dt=dt)
        qh = q.view(b, TQ, HEADS, -1).transpose(1, 2).contiguous()
        kh, vh = (t.view(b, TK, HEADS, -1).transpose(1, 2)[:, :, :T]
                  .contiguous() for t in kv.split(D, -1))
        runs["attention_cp" + sfx] = (
            lambda q=q, kv=kv: att.fused_attention_qkv_cp(q, kv, HEADS, T),
            lambda qh=qh, kh=kh, vh=vh: sdpa(qh, kh, vh))
        cp_runs("attention_cp_bwd" + sfx, b, TQ, TK, T, dt, True)
    module_runs("", B, T, torch.bfloat16)
    module_runs("_f32", B32, T, torch.float32)
    for t in T_PAST:
        module_runs(f"_{t}", B384, t, torch.bfloat16)
        module_runs(f"_{t}_f32", B384, t, torch.float32)
    # kernels 1 and 3 (no library call): LN scales near 1, fan-in weights
    blk = dict(xp=rand(B, TP, D), ln_scale=scaled(D, scale=0.1, shift=1.0,
                                                 dt=torch.float32),
               ln_bias=scaled(D, scale=0.1, dt=torch.float32),
               w_qkv=scaled(D, 3 * D, scale=D ** -0.5),
               b_qkv=scaled(3 * D, scale=0.1, dt=torch.float32),
               w_proj=scaled(D, D, scale=D ** -0.5),
               b_proj=scaled(D, scale=0.1, dt=torch.float32))
    runs["attention_block"] = (lambda: att.fused_attention_block_padded(
        **blk, num_heads=HEADS, valid_len=T), None)
    runs["attention_block_train"] = (lambda: att.attention_block_train_padded(
        **blk, num_heads=HEADS, valid_len=T), None)
    # their f32 forms at B 32, and kernels 2 and 7 (bf16 B 128 / 25,216
    # rows, f32 6,304 rows), with no library call
    blk32 = {k: v[:B32].float() if k == "xp" else v.float()
             for k, v in blk.items()}
    runs["attention_block_f32"] = (lambda: att.fused_attention_block_padded(
        **blk32, num_heads=HEADS, valid_len=T), None)
    runs["attention_block_train_f32"] = (
        lambda: att.attention_block_train_padded(
            **blk32, num_heads=HEADS, valid_len=T), None)
    mlp = dict(ln_scale=scaled(D, scale=0.1, shift=1.0, dt=torch.float32),
               ln_bias=scaled(D, scale=0.1, dt=torch.float32),
               w_fc1=scaled(D, 4 * D, scale=D ** -0.5),
               b_fc1=scaled(4 * D, scale=0.1, dt=torch.float32),
               w_fc2=scaled(4 * D, D, scale=(4 * D) ** -0.5),
               b_fc2=scaled(D, scale=0.1, dt=torch.float32))
    x_mlp = rand(B, TP, D)
    runs["mlp_block"] = (lambda: att.fused_mlp_block(x_mlp, **mlp), None)
    rows = x_mlp[:, :T].reshape(-1, D).contiguous()
    mlp32 = {k: v.float() for k, v in mlp.items()}
    rows32 = rows[:B32 * T].float()
    runs["mlp_block_train"] = (lambda: att.mlp_block_train(
        rows, **mlp, approximate=False), None)
    runs["mlp_block_train_f32"] = (lambda: att.mlp_block_train(
        rows32, **mlp32, approximate=False), None)
    # the GEMM cores alone beside torch.matmul (TF32 off), where the tree
    # has them
    try:
        from vit_spoof_detection_pda_tpu_torch.ops import gemm as gm
    except ImportError:
        gm = None
    if gm is not None:
        for dt, m, sfx in ((torch.bfloat16, B * TP, ""),
                           (torch.float32, B32 * TP, "_f32")):
            for name, n, k in (("qkv", 3 * D, D), ("proj", D, D),
                               ("fc1", 4 * D, D), ("fc2", D, 4 * D)):
                a_g = rand(m, k, dt=dt)
                w_g = scaled(k, n, scale=k ** -0.5, dt=dt)
                b_g = scaled(n, scale=0.1, dt=torch.float32)

                def lib_mm(a_g=a_g, w_g=w_g):
                    with exact_f32_matmul():
                        return torch.matmul(a_g, w_g)
                runs[f"gemm_{name}{sfx}"] = (
                    lambda a_g=a_g, w_g=w_g, b_g=b_g: gm.gemm(a_g, w_g, b_g),
                    lib_mm)
                if n == D:  # proj and fc2 with the blocks' residual epilogue
                    r_g = rand(m, n, dt=dt)
                    runs[f"gemm_{name}_res{sfx}"] = (
                        lambda a_g=a_g, w_g=w_g, b_g=b_g, r_g=r_g: gm.gemm(
                            a_g, w_g, b_g, epilogue="bias_residual",
                            residual=r_g), lib_mm)
    # the module forwards kernel 8 sits in (12 launches each): the `test`
    # verb's bf16 ViTAntiSpoof at B 128 and evaluate-all's f32
    # ViTLinearHead at B 32, on seeded random weights
    images = rand(B, 224, 224, 3, dt=torch.float32)
    for name, entry, dt, x in (
            ("module_forward_bf16", "Custom_ViT_FineTuned", torch.bfloat16,
             images),
            ("vit_linear_head_f32", "Base_ViT_Pretrained", torch.float32,
             images[:B32])):
        model = registry.build_model(entry, dtype=dt)

        def forward(model=model, x=x):
            with torch.inference_mode(), exact_f32_matmul():
                return model(x)
        runs[name] = (forward, None)
    # the B 128 scoring forward (fastserve: 12 launches each of kernels 1
    # and 2) on uint8 faces
    from vit_spoof_detection_pda_tpu_torch.models import fastserve
    serve = fastserve.make_serving_fn(
        registry.build_model("Custom_ViT_FineTuned"), batch_size=B,
        mode="fastserve")
    faces = torch.from_numpy(rng.integers(0, 256, (B, 224, 224, 3)).astype(
        np.uint8))
    runs["serving_forward_b128"] = (lambda: serve(faces), None)
    # the training step around kernel 4 (12 launches a step): the bf16
    # fasttrain step at B 128 and the f32 step at B 32 (make_train_step,
    # focal loss, AdamW; the parameters move in place from step to step)
    from vit_spoof_detection_pda_tpu_torch.models import fasttrain
    from vit_spoof_detection_pda_tpu_torch.ops.losses import make_loss_fn
    from vit_spoof_detection_pda_tpu_torch.train.state import (
        create_train_state, make_optimizer)
    from vit_spoof_detection_pda_tpu_torch.train.step import make_train_step
    labels = torch.from_numpy(rng.integers(0, 2, B)).to(dev)
    for name, dt, b in (("train_step_bf16", torch.bfloat16, B),
                        ("train_step_f32", torch.float32, B32),
                        ("train_step_bf16_hidden", torch.bfloat16, B)):
        if only and name not in only:
            continue
        model = registry.build_model("Custom_ViT_FineTuned", dropout=0.0)
        kw = {"mlp_mode": "hidden"} if name.endswith("_hidden") else {}
        state = create_train_state(
            model, make_optimizer(3e-4), 0, device=dev,
            apply_fn=fasttrain.make_apply(model, dtype=dt, **kw))
        step = make_train_step(make_loss_fn("focal"))
        batch = {"image": images[:b], "label": labels[:b]}

        def train_step(state=state, step=step, batch=batch):
            with exact_f32_matmul():
                return step(state, batch)[1]["loss"]
        runs[name] = (train_step, None)
        del model
    # kernels 10 and 11 on random packs of the 12 layers (W [36, D, 4D],
    # S [36, 4, 4D]: LN scales near 1, small biases): kernel 10 at B 1
    # encoder-only, fold-ends (``lowlat_e2e``, random stem and head
    # blocks) and on the int8 pack (``lowlat_encoder_int8``: the per-column
    # scales of pack_encoder_weights), kernel 11 per chunk of 2 and of 4
    s_pack = scaled(36, 4, 4 * D, scale=0.05, dt=torch.float32)
    s_pack[:, 0] += 1.0
    w_pack = scaled(36, D, 4 * D, scale=D ** -0.5)
    wf = w_pack.float()
    q_scale = torch.clamp(wf.abs().amax(dim=1), min=1e-12) / 127.0
    w_q8 = torch.clamp(torch.round(wf / q_scale[:, None, :]), -127,
                       127).to(torch.int8)
    s_q8 = torch.cat([s_pack, q_scale[:, None, :]], 1).contiguous()
    del wf
    hh = 512
    w_end = scaled(1, D, D + hh, scale=D ** -0.5)
    s_end = scaled(1, 4, 4 * D, scale=0.05, dt=torch.float32)
    s_end[:, 0] += 1.0
    aux = scaled(1, TP, D, scale=0.02, dt=torch.float32)
    patches = torch.from_numpy(rng.integers(0, 256, (1, TP, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    patches[:, 0] = 0
    patches[:, T:] = 0
    for name, fn, b, w, s in (
            ("lowlat_encoder", low.encoder_forward_lowlat, 1, w_pack, s_pack),
            ("lowlat_encoder_int8", low.encoder_forward_lowlat, 1, w_q8,
             s_q8),
            ("lowlat_batchgrid", low.encoder_forward_lowlat_batchgrid, 2,
             w_pack, s_pack),
            ("lowlat_batchgrid_4", low.encoder_forward_lowlat_batchgrid, 4,
             w_pack, s_pack)):
        xp = rand(b, TP, D)
        runs[name] = (lambda fn=fn, xp=xp, w=w, s=s: fn(
            xp, w, s, num_heads=HEADS, valid_len=T), None)
    runs["lowlat_e2e"] = (lambda: low.forward_lowlat_e2e(
        patches, w_pack, s_pack, w_end, s_end, aux, num_heads=HEADS,
        valid_len=T), None)
    # kernel 14 at the pool step's gather (B 128 faces of 150,528 bytes
    # from a 4,096-face pool) beside index_select on the same device
    # indices: warm (the same rows every call, ``pool_gather``) and cold
    # (each call the next of 8 sets of distinct rows, 154 MB past the L2,
    # ``pool_gather_cold``); the wrappers with their host check and upload
    # (``pool_gather_wrapper``, beside the plain version's); kernel 17 on
    # the doctor's [8, 128] beside torch.mul (``doctor_probe``)
    from vit_spoof_detection_pda_tpu_torch.ops import gather as ga
    from vit_spoof_detection_pda_tpu_torch.ops import probe as pr
    pool = torch.randint(0, 256, (4096, 224, 224, 3), dtype=torch.uint8,
                         device=dev, generator=torch.Generator(
                             device=dev).manual_seed(0))
    host_sets = rng.permutation(4096)[:8 * B].reshape(8, B)
    sets = torch.from_numpy(host_sets).to(dev)
    sets32 = sets.int()
    kernel_sets, library_sets = itertools.cycle(sets32), itertools.cycle(sets)
    rows_out = torch.empty((B, 224, 224, 3), dtype=torch.uint8, device=dev)

    def gather_rows(i32):
        ga.gather_rows(pool, i32, rows_out)
        return rows_out
    runs["pool_gather"] = (lambda: gather_rows(sets32[0]),
                           lambda: pool.index_select(0, sets[0]))
    runs["pool_gather_cold"] = (
        lambda: gather_rows(next(kernel_sets)),
        lambda: pool.index_select(0, next(library_sets)))
    runs["pool_gather_wrapper"] = (
        lambda: ga.pool_gather(pool, host_sets[0]),
        lambda: ga.pool_gather_plain(pool, host_sets[0]))
    x_probe = torch.ones((8, 128), device=dev)
    runs["doctor_probe"] = (lambda: pr.doctor_probe(x_probe),
                            lambda: torch.mul(x_probe, 2.0))
    # kernel 15 at the tower's timed shape (a full f32 field at kmax 33,
    # a broadcast per-row field at kmax 11), no library call
    from vit_spoof_detection_pda_tpu_torch.ops import warp as wp
    img = torch.from_numpy(rng.random((B, 224, 224, 3), dtype=np.float32)
                           ).to(dev)
    img16 = img.bfloat16()
    field = torch.from_numpy(((rng.random((B, 224, 224)) * 2 - 1) * 32.0)
                             .astype(np.float32)).to(dev)
    rot = (torch.from_numpy(((rng.random((B, 224)) * 2 - 1) * 10.0)
                            .astype(np.float32)).to(dev)[:, :, None]
           .expand(B, 224, 224))
    runs["warp_pass"] = (lambda: wp.warp_pass(img16, field, 33), None)
    runs["warp_pass_cols"] = (
        lambda: wp.warp_pass(img16, field, 33, along_y=True), None)
    runs["warp_pass_rot"] = (lambda: wp.warp_pass(img16, rot, 11), None)
    runs["warp_pass_f32"] = (lambda: wp.warp_pass(img, field, 33), None)
    # kernel 6 at the step's shape beside native_layer_norm_backward plus
    # the residual add (it recomputes xhat from mean 0 and rstd = inv)
    from vit_spoof_detection_pda_tpu_torch.ops import ln_bwd as lb
    for name, b, xdt, ddt in (
            ("ln_res_bwd", B, torch.bfloat16, torch.bfloat16),
            ("ln_res_bwd_f32dxn", B, torch.bfloat16, torch.float32),
            ("ln_res_bwd_f32", B32, torch.float32, torch.float32)):
        xh, g2 = rand(b, TP, D, dt=xdt), rand(b, TP, D, dt=xdt)
        dxn = rand(b, TP, D, dt=ddt)
        inv = torch.from_numpy(rng.uniform(0.5, 2.0, (b, TP, 1)).astype(
            np.float32)).to(dev)
        lns = scaled(D, scale=0.1, shift=1.0, dt=torch.float32)
        w_ln = lns.to(xdt)
        bias_ln = torch.zeros_like(w_ln)
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            xh, [D], w_ln, bias_ln, 1e-6)
        mean = torch.zeros_like(mean)
        rstd = inv.to(rstd.dtype).view(rstd.shape)

        def ln_lib(xh=xh, dxn=dxn.to(xdt), g2=g2, mean=mean, rstd=rstd,
                   w_ln=w_ln, bias_ln=bias_ln):
            dx, dw, db = torch.ops.aten.native_layer_norm_backward(
                dxn, xh, [D], mean, rstd, w_ln, bias_ln, [True, True, True])
            return dx + g2, dw, db
        runs[name] = (lambda xh=xh, inv=inv, dxn=dxn, g2=g2, lns=lns:
                      lb.ln_residual_bwd(xh, inv, dxn, g2, lns), ln_lib)
    tiled = hasattr(att, "tiled_bwd_plan")
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        qkv, g = (rand(B384, TP384, 3 * D, dt=dt),
                  rand(B384, TP384, D, dt=dt))
        g[:, T384:] = 0
        runs["attention_qkv_bwd_phased_384" + sfx] = (
            lambda qkv=qkv, g=g: att.attention_qkv_bwd_phased(
                qkv, g, HEADS, valid_len=T384),
            sdpa_bwd(qkv, g, TP384, T384))
        if tiled:
            cp_runs("attention_cp_bwd_384" + sfx, B384, TQ384, TK384, T384,
                    dt, True)
    if tiled:
        # every route of the backward at the main shapes: the key-tiled
        # backward forced where kernels 4, 5 and 13 run their own
        # (``..._kt``); kernel 13 at the 4-rank block (Tq 56, Tk 224),
        # directly and forced; kernels 4 and 5 and the forced key tiles at
        # f32 Tp 264 (ViT-B/16 at 256 px: T 257) and at f32 head dims 48
        # and 128 (16 and 6 heads of D 768)
        for dt, b, sfx in ((torch.bfloat16, B, ""),
                           (torch.float32, B32, "_f32")):
            qkv, g = rand(b, TP, 3 * D, dt=dt), rand(b, TP, D, dt=dt)
            g[:, T:] = 0
            runs["attention_qkv_bwd_kt" + sfx] = (
                lambda qkv=qkv, g=g: kt_qkv(qkv, g, HEADS, T),
                sdpa_bwd(qkv, g, TP, T))
            cp_runs("attention_cp_bwd_kt" + sfx, b, TQ, TK, T, dt, True,
                    kt=True)
        cp_runs("attention_cp_bwd_sp4", B, TQ4, TK4, T, torch.bfloat16, True)
        cp_runs("attention_cp_bwd_sp4_kt", B, TQ4, TK4, T, torch.bfloat16,
                True, kt=True)
        for tp, t, heads, sfx in ((TP256, T256, HEADS, "_264_f32"),
                                  (TP, T, 16, "_dh48_f32"),
                                  (TP, T, 6, "_dh128_f32")):
            qkv = rand(B32, tp, 3 * D, dt=torch.float32)
            g = rand(B32, tp, D, dt=torch.float32)
            g[:, t:] = 0
            lib = sdpa_bwd(qkv, g, tp, t, heads)
            runs["attention_qkv_bwd" + sfx] = (
                lambda qkv=qkv, g=g, t=t, h=heads: att.attention_qkv_bwd(
                    qkv, g, h, valid_len=t), lib)
            runs["attention_qkv_bwd_phased" + sfx] = (
                lambda qkv=qkv, g=g, t=t, h=heads:
                att.attention_qkv_bwd_phased(qkv, g, h, valid_len=t), lib)
            runs["attention_qkv_bwd_kt" + sfx] = (
                lambda qkv=qkv, g=g, t=t, h=heads: kt_qkv(qkv, g, h, t), lib)
        # shapes past the one-launch core that the parent's body held:
        # kernel 4 at bf16 Tp 224 (221 valid) and head dims 16 and 32 (48
        # and 24 heads of D 768), kernel 13 at bf16 Tq 128 / Tk 256 (250
        # valid keys), both at f32 head dim 96 (8 heads)
        for heads, sfx in ((48, "_224_dh16"), (24, "_224_dh32")):
            qkv, g = rand(B, 224, 3 * D), rand(B, 224, D)
            g[:, 221:] = 0
            runs["attention_qkv_bwd" + sfx] = (
                lambda qkv=qkv, g=g, h=heads: att.attention_qkv_bwd(
                    qkv, g, h, valid_len=221),
                sdpa_bwd(qkv, g, 224, 221, heads))
        cp_runs("attention_cp_bwd_128x256", B, 128, 256, 250,
                torch.bfloat16, True)
        qkv = rand(B32, TP, 3 * D, dt=torch.float32)
        g = rand(B32, TP, D, dt=torch.float32)
        g[:, T:] = 0
        runs["attention_qkv_bwd_dh96_f32"] = (
            lambda qkv=qkv, g=g: att.attention_qkv_bwd(qkv, g, 8,
                                                       valid_len=T),
            sdpa_bwd(qkv, g, TP, T, 8))
        cp_runs("attention_cp_bwd_dh96_f32", B32, TQ, TK, T, torch.float32,
                True, heads=8)
        cp_runs("attention_cp_384_f32", B384, TQ384, TK384, T384,
                torch.float32, False)
        # kernel 12's bf16 key tiles at 512 px
        cp_runs("attention_cp_512", B384, TP512 // 2, TP512, T512,
                torch.bfloat16, False)

    def window(fn, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def windows(fn):
        """5 windows of at least 20 calls and 2 ms each (short calls at
        B 8 spread by tens of percent over 20-call windows)."""
        for _ in range(3):
            fn()
        n = max(20, int(2.0 / window(fn, 5)) + 1)
        return [window(fn, n) for _ in range(5)]

    def device_ms(fn, n=10):
        """The card's time a call (every kernel and copy of ``n`` calls,
        from torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   ) / 1e3 / n

    ms, lib_ms, dev_ms, sums = {}, {}, {}, {}
    if only:
        runs = {k: v for k, v in runs.items() if k in only}
    # the training steps last: a profile of a whole step's thousands of
    # kernels leaves later profiles of one kernel short of events
    runs = dict(sorted(runs.items(),
                       key=lambda kv: kv[0].startswith("train_step")))
    for name, (run, lib) in runs.items():
        wk, wl = [], []
        for fn, acc in ((run, wk), (lib, wl), (lib, wl), (run, wk)):
            if fn is not None:
                acc += windows(fn)
        ms[name] = statistics.median(wk)
        lib_ms[name] = statistics.median(wl) if wl else None
        dev_ms[name] = [device_ms(fn) if fn else None for fn in (run, lib)]
        out = run()
        out = out if isinstance(out, (tuple, list)) else (out,)
        sums[name] = [float(o.float().abs().sum()) for o in out]
    print(json.dumps({"tree": tree, "ms": ms, "library_ms": lib_ms,
                      "device_ms": dev_ms, "ptxas": ptxas,
                      "out_abs_sums": sums}))


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        _child(argv[1], argv[2:])
        return 0
    only = []
    if argv[:1] == ["--only"] and len(argv) > 1:
        only, argv = argv[1].split(","), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", tree, *only],
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
