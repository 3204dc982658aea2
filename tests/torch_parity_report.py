"""Print the port's parity gaps against the JAX package on the CPU, one
JSON line per comparison (the numbers the tests bound).

    python tests/torch_parity_report.py [kernels serving training small_batch augment eval train_loop cli artifact int8_vitb parallel long]

The port runs its plain PyTorch versions (CPU tensors); the JAX side runs
its Pallas kernels in interpret mode, as the test files do.  Inputs come
from the same numpy seeds and flax inits as tests/test_torch_*.py.
"""

import json
import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_attention as ta  # noqa: E402
import test_torch_fasttrain as tf  # noqa: E402
import test_torch_lowlat as tlt  # noqa: E402
import test_torch_train_step as tts  # noqa: E402
from vit_spoof_detection_pda_tpu.models import fastserve as jfast  # noqa: E402
from vit_spoof_detection_pda_tpu.models import vit as jvit  # noqa: E402
from vit_spoof_detection_pda_tpu.models import fasttrain as jft  # noqa: E402
from vit_spoof_detection_pda_tpu.ops import attention as jatt  # noqa: E402
from vit_spoof_detection_pda_tpu.ops import ln_bwd as jln  # noqa: E402
from vit_spoof_detection_pda_tpu.ops import lowlat as jlow  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models import fasttrain as tft  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import ln_bwd as tln  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import lowlat as tlow  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train import state as tstate  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import attention as tatt  # noqa: E402


def gap(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return {"max_abs": float(np.abs(got - want).max()),
            "max_abs_ref": float(np.abs(want).max()),
            "bit_equal_frac": float((got == want).mean())}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def kernels():
    for dtype in ta.DTYPES:
        jdt, tdt = ta.DTYPES[dtype]
        for b, t, d, heads in ((2, 33, 64, 4), (3, 33, 64, 4),
                               (2, 197, 64, 2)):
            tp = tatt._round_up(t, 8)
            inp = ta._attn_inputs(0, b, tp, d)
            inp["x"][:, t:] = 0.0
            ja, tt = ta._jax_args(inp, jdt), ta._torch_args(inp, tdt)
            want = jatt.fused_attention_block_padded(
                ja.pop("x"), *ja.values(), heads, valid_len=t,
                interpret=True)
            got = tatt.fused_attention_block_padded(
                tt.pop("x"), *tt.values(), heads, valid_len=t)
            emit(what="attention_block", dtype=dtype, b=b, t=t, d=d,
                 heads=heads, **gap(got.float().numpy(), want))
        for b, t in ((2, 40), (3, 200)):
            inp = ta._mlp_inputs(2, b, t, 64, 256)
            ja, tt = ta._jax_args(inp, jdt), ta._torch_args(inp, tdt)
            want = jatt.fused_mlp_block(ja.pop("x"), *ja.values(),
                                        interpret=True)
            got = tatt.fused_mlp_block(tt.pop("x"), *tt.values())
            emit(what="mlp_block", dtype=dtype, b=b, t=t, d=64, hidden=256,
                 **gap(got.float().numpy(), want))


def serving():
    geom = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)
    for seed in range(3):
        jm = jvit.ViTAntiSpoof(**geom, gelu="tanh")
        v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
        folded = jvit.fold_normalization(v)
        params = jax.tree.map(np.asarray, folded["params"])
        u8 = np.random.default_rng(seed).integers(
            0, 256, (64, 32, 32, 3), dtype=np.uint8)
        for jdt, tdt, name in ((jnp.float32, torch.float32, "f32"),
                               (jnp.bfloat16, torch.bfloat16, "bf16")):
            want = jfast.serving_forward(
                folded["params"], jnp.asarray(u8), num_heads=2, depth=2,
                dtype=jdt, interpret=True)
            got = tfast.serving_forward(params, u8, num_heads=2, depth=2,
                                        dtype=tdt, device="cpu")
            emit(what="serving_forward_scores", dtype=name, init_seed=seed,
                 images=64, **gap(got.numpy(), want))


def training():
    """The training slice: kernels 3, 4 and 6 (plain versions) against the
    JAX kernels in interpret mode, and the whole forward's logits and
    per-leaf gradients against JAX make_apply at f32."""
    for dtype in ("f32", "bf16"):
        jdt, tdt = tf.DT[dtype]
        args = tf._attn_args(0, 2, 33, 64)
        want = jft._attn_block_fwd_pallas(*tf._jax_args(args, jdt), 4, 1e-6,
                                          True)
        got = tft.attn_block_train_fwd(*tf._torch_args(args, tdt), 4, 1e-6)
        for name, g, w in zip(("o", "qkv", "attn", "xh", "inv"), got, want):
            emit(what=f"attention_block_train.{name}", dtype=dtype,
                 **gap(g.float().numpy(), w))
        rng = np.random.default_rng(1)
        qkv = rng.standard_normal((3, 200, 384)).astype(np.float32)
        g = rng.standard_normal((3, 200, 128)).astype(np.float32)
        g[:, 197:] = 0.0
        want = jatt._backward_qkv(jnp.asarray(qkv, jdt), jnp.asarray(g, jdt),
                                  2, interpret=True, valid_len=197)
        got = tatt.attention_qkv_bwd(torch.tensor(qkv).to(tdt),
                                     torch.tensor(g).to(tdt), 2,
                                     valid_len=197)
        emit(what="attention_qkv_bwd", dtype=dtype,
             **gap(got.float().numpy(), want))
        xh, inv, dxn, g, lns = (rng.standard_normal((3, 200, 128)),
                                rng.uniform(0.5, 2, (3, 200, 1)),
                                rng.standard_normal((3, 200, 128)),
                                rng.standard_normal((3, 200, 128)),
                                1 + 0.1 * rng.standard_normal(128))
        want = jln.ln_residual_bwd(
            jnp.asarray(xh, jdt), jnp.asarray(inv, jnp.float32),
            jnp.asarray(dxn, jdt), jnp.asarray(g, jdt),
            jnp.asarray(lns, jnp.float32), interpret=True)
        got = tln.ln_residual_bwd(
            torch.tensor(xh).to(tdt), torch.tensor(inv).float(),
            torch.tensor(dxn).to(tdt), torch.tensor(g).to(tdt),
            torch.tensor(lns).float())
        for name, gg, w in zip(("dx", "dscale", "dbias"), got, want):
            emit(what=f"ln_res_bwd.{name}", dtype=dtype,
                 **gap(gg.float().numpy(), w))

    for mode in ("hidden", "autodiff"):
        jm, variables, tm = tf._models()
        x = tf._batch()
        labels = np.array([0, 1])
        with jatt.attention_sharding(interpret=True):
            jfast_ = jft.make_apply(jm, mlp_mode=mode)
            want_logits = jfast_(variables, jnp.asarray(x))
            want = jax.grad(lambda p: tf._nll(
                jfast_({"params": p}, jnp.asarray(x)), jnp.asarray(labels),
                jnp))(variables["params"])
        params = tf._torch_params(variables)
        logits = tft.make_apply(tm, dtype=torch.float32, mlp_mode=mode)(
            {"params": params}, torch.tensor(x))
        tf._nll(logits, torch.tensor(labels), torch).backward()
        emit(what="train_forward.logits", mlp_mode=mode, dtype="f32",
             **gap(logits.detach().numpy(), want_logits))
        leaves = tstate.tree_flatten(params)[0]
        jleaves = jax.tree.leaves(want)
        worst = max((gap(a.grad.numpy(), b)["max_abs"], i)
                    for i, (a, b) in enumerate(zip(leaves, jleaves)))
        emit(what="train_forward.param_grads", mlp_mode=mode, dtype="f32",
             leaves=len(leaves), worst_leaf_max_abs=worst[0],
             worst_leaf=str(tstate.tree_flatten(params)[1][worst[1]]))

    jstate, port = tts._jax_and_port_states(ema_decay=0.99)
    jstep = tts.j_train_step(tts.jl.make_loss_fn("focal"), donate=False)
    pstep = tts.ST.make_train_step(tts.tl.make_loss_fn("focal"))
    batch = tts._batch(0)
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    port, pmet = pstep(port, batch)
    emit(what="train_step.metrics", dtype="f32",
         **{k: abs(float(pmet[k]) - float(jmet[k]))
            for k in ("loss", "accuracy", "grad_norm")})
    gaps = [gap(a.detach().numpy(), b)["max_abs"] for a, b in zip(
        tstate.tree_flatten(port.params)[0], jax.tree.leaves(jstate.params))]
    emit(what="train_step.params_after_one_step", dtype="f32",
         max_abs=max(gaps), note="includes the qkv key-bias thirds, whose "
         "gradient is zero in exact arithmetic (see test_torch_train_step)")


def small_batch():
    """The small-batch slice: the whole-encoder kernels' plain versions
    against the JAX kernels in interpret mode (depth 1 at bf16, 2 at f32,
    as tests/test_torch_lowlat.py holds them), and the lowlat and
    batch-grid scores of 16 images at both of its geometries."""
    geoms = {name: tlt._geometry(name) for name in ("small", "foldable")}
    for jdt, tdt in tlt.DTYPES:
        dtype = "f32" if tdt == torch.float32 else "bf16"
        depth = 2 if dtype == "f32" else 1
        g = geoms["small"]
        for bg, b, jfn, tfn in (
                (False, 2, jlow.encoder_forward_lowlat,
                 tlow.encoder_forward_lowlat),
                (True, 3, jlow.encoder_forward_lowlat_batchgrid,
                 tlow.encoder_forward_lowlat_batchgrid)):
            (jw, js), (tw, ts) = tlt._packs(g, depth, jdt, tdt, batch_grid=bg)
            x, xj = tlt._stream(7, b, 8, 64, jdt)
            want = jfn(xj, jw, js, num_heads=2, valid_len=5, interpret=True)
            got = tfn(torch.tensor(x).to(tdt), tw, ts, num_heads=2,
                      valid_len=5)
            emit(what=tfn.__name__, dtype=dtype, b=b, depth=depth,
                 **gap(got.float().numpy(), want))
        g = geoms["foldable"]
        (jw, js), (tw, ts) = tlt._packs(g, depth, jdt, tdt)
        x, _ = tlt._stream(8, 3, 8, 48, jdt)
        x[:, 0], x[:, 5:] = 0, 0
        want = jlow.forward_lowlat_e2e(
            jnp.asarray(x, jdt), jw, js,
            *jlow.pack_end_weights(g["folded"]["params"], dtype=jdt),
            num_heads=2, valid_len=5, interpret=True)
        got = tlow.forward_lowlat_e2e(
            torch.tensor(x).to(tdt), tw, ts,
            *tlow.pack_end_weights(g["np"], dtype=tdt), num_heads=2,
            valid_len=5)
        emit(what="forward_lowlat_e2e", dtype=dtype, b=3, depth=depth,
             **gap(got.numpy(), want))
        for name, g in geoms.items():
            u8 = tlt._images(9, 16, g["img"])
            kw = dict(num_heads=2, patch_size=g["patch"])
            for batch_grid in (False, True):
                jprep = jfast.prepare_lowlat(g["folded"]["params"], depth=2,
                                             dtype=jdt, batch_grid=batch_grid)
                tprep = tfast.prepare_lowlat(g["np"], depth=2, dtype=tdt,
                                             batch_grid=batch_grid,
                                             device="cpu")
                if batch_grid:
                    want = jfast.serving_forward_lowlat_batch(
                        jprep, jnp.asarray(u8), dtype=jdt, interpret=True,
                        **kw)
                    got = tfast.serving_forward_lowlat_batch(
                        tprep, u8, dtype=tdt, device="cpu", **kw)
                else:
                    want = jfast.serving_forward_lowlat(
                        jprep, jnp.asarray(u8), dtype=jdt, interpret=True,
                        **kw)
                    got = tfast.serving_forward_lowlat(
                        tprep, u8, dtype=tdt, device="cpu", **kw)
                emit(what=("serving_forward_lowlat_batch" if batch_grid
                           else "serving_forward_lowlat") + "_scores",
                     geometry=name, dtype=dtype, images=16,
                     **gap(got.numpy(), want))


def augment():
    """The augmentation slice: the warp pass's plain version against the
    JAX Pallas kernel (interpret mode) and the XLA roll form, the tower's
    warps, every op, tier and train-time chain fed JAX's draws (f32, and
    bf16 with JAX's warp on its TPU path), the NLM and eval preprocessing,
    the pool gather, index streams and one pool step, as the tests of
    tests/test_torch_{warp,augment,nlm,pool}.py hold them."""
    import contextlib
    import functools

    import test_torch_augment as tag
    import test_torch_nlm as tnl
    import test_torch_pool as tpl
    import test_torch_warp as twp
    from vit_spoof_detection_pda_tpu.ops import image as jimg
    from vit_spoof_detection_pda_tpu.ops import nlm as jnlm
    from vit_spoof_detection_pda_tpu.ops import nlm_pallas as jnlmp
    from vit_spoof_detection_pda_tpu.ops import warp as jwarp
    from vit_spoof_detection_pda_tpu.ops import warp_pallas as jwp
    from vit_spoof_detection_pda_tpu.ops.gather_pallas import pool_gather
    from vit_spoof_detection_pda_tpu.train import pool as jpool
    from vit_spoof_detection_pda_tpu.train.step import make_train_step
    from vit_spoof_detection_pda_tpu_torch.ops import gather as tgather
    from vit_spoof_detection_pda_tpu_torch.ops import image as timg
    from vit_spoof_detection_pda_tpu_torch.ops import nlm as tnlm
    from vit_spoof_detection_pda_tpu_torch.ops import warp as twarp
    from vit_spoof_detection_pda_tpu_torch.train import pool as tpool

    for along_y in (False, True):
        img, field = twp._img(1, 2, 31, 29), twp._field(2, 2, 31, 29, 3.9)
        emit(what="warp_pass_plain_vs_pallas", dtype="f32", along_y=along_y,
             **gap(twp._port(img, field, 4, along_y).numpy(),
                   twp._pallas(img, field, 4, along_y)))
        ib = img.astype(jnp.bfloat16)
        emit(what="warp_pass_plain_vs_pallas", dtype="bf16", along_y=along_y,
             **gap(twp._port(ib.astype(np.float32), field, 4, along_y,
                             torch.bfloat16).float().numpy(),
                   twp._pallas(ib, field, 4, along_y)))
        fn = jwarp._resample_cols_field if along_y else \
            jwarp._resample_rows_field
        emit(what="warp_pass_plain_vs_xla_roll", dtype="f32", along_y=along_y,
             **gap(twp._port(img, field, 4, along_y).numpy(),
                   np.stack([fn(jnp.asarray(img[i]), jnp.asarray(field[i]), 4)
                             for i in range(2)])))
    img = twp._img(11, 3, 32, 32)
    theta = np.deg2rad(np.array([-20.0, 6.0, 19.4], np.float32))
    emit(what="rotate_3shear", dtype="f32", **gap(
        twarp.rotate_3shear(torch.tensor(img), torch.tensor(theta), 20.0),
        np.stack([jwarp.rotate_3shear(jnp.asarray(img[i]),
                                      jnp.float32(theta[i]), 20.0)
                  for i in range(3)])))
    hm = twp._homographies(13, 3, 32)
    emit(what="perspective_warp_2pass", dtype="f32", **gap(
        twarp.perspective_warp_2pass(torch.tensor(img), torch.tensor(hm), 7),
        np.stack([jwarp.perspective_warp_2pass(jnp.asarray(img[i]),
                                               jnp.asarray(hm[i]), 7)
                  for i in range(3)])))
    dy, dx = twp._field(15, 3, 32, 32, 3.0), twp._field(16, 3, 32, 32, 3.0)
    emit(what="displacement_warp_2pass", dtype="f32", **gap(
        twarp.displacement_warp_2pass(torch.tensor(img), torch.tensor(dy),
                                      torch.tensor(dx), 4),
        np.stack([jwarp.displacement_warp_2pass(
            jnp.asarray(img[i]), jnp.asarray(dy[i]), jnp.asarray(dx[i]), 4)
            for i in range(3)])))

    for name in sorted(tag.OPS):
        port_op, jax_op = tag.OPS[name]
        key, batch = jax.random.PRNGKey(len(name)), tag._batch(1, b=6)
        emit(what=f"op.{name}", dtype="f32", **gap(
            tag._port_chain([port_op()], key, batch, torch.float32),
            tag._jax_chain([jax_op], key, batch, jnp.float32)))
    for name in sorted(tag.CHAINS):
        port_chain, jax_chain, size = tag.CHAINS[name]
        key, batch = jax.random.PRNGKey(7), tag._batch(3, b=6, h=size, w=size)
        emit(what=f"chain.{name}", dtype="f32", **gap(
            tag._port_chain(port_chain(), key, batch, torch.float32),
            tag._jax_chain(jax_chain(), key, batch, jnp.float32)))

    @contextlib.contextmanager
    def jax_tpu_warp_path():
        """tests/test_torch_augment.py's fixture of the same name."""
        saved = (jwarp._use_pallas_rolls, jwp.resample_rows_field_pallas,
                 jwp.resample_cols_field_pallas)
        jwarp._use_pallas_rolls = lambda: True
        jwp.resample_rows_field_pallas = functools.partial(saved[1],
                                                           interpret=True)
        jwp.resample_cols_field_pallas = functools.partial(saved[2],
                                                           interpret=True)
        try:
            yield
        finally:
            (jwarp._use_pallas_rolls, jwp.resample_rows_field_pallas,
             jwp.resample_cols_field_pallas) = saved

    with jax_tpu_warp_path():
        for name in ("heavy", "train_time"):
            port_chain, jax_chain, size = tag.CHAINS[name]
            key = jax.random.PRNGKey(8)
            batch = np.asarray(jnp.asarray(tag._batch(4, b=6, h=size, w=size),
                                           jnp.bfloat16).astype(jnp.float32))
            got = tag._port_chain(port_chain(), key, batch, torch.bfloat16)
            want = tag._jax_chain(jax_chain(), key, batch, jnp.bfloat16)
            emit(what=f"chain.{name}", dtype="bf16",
                 mean_abs=float(np.abs(got.float().numpy() - want).mean()),
                 **gap(got.float().numpy(), want))

    img = tnl._imgs(0, (2, 16, 16, 3))
    emit(what="nlm_plain_vs_xla", dtype="f32", **gap(
        tnlm.fast_nlm_denoise(torch.tensor(img)),
        jnlm.fast_nlm_denoise(jnp.asarray(img), use_pallas=False)))
    kw = dict(h=0.2, sigma=0.05, search_radius=2, patch_radius=1)
    img = tnl._imgs(1, (2, 16, 16, 3))
    emit(what="nlm_plain_vs_pallas_interpret", dtype="f32", **gap(
        tnlm.nlm_denoise_plain(torch.tensor(img), **kw),
        jnlmp.nlm_denoise_pallas(jnp.asarray(img), interpret=True, **kw)))
    x = tnl._imgs(3, (2, 20, 30, 3))
    emit(what="resize_bilinear", dtype="f32", **gap(
        timg.resize_bilinear(torch.tensor(x), (24, 12)),
        jimg.resize_bilinear(jnp.asarray(x), (24, 12))))
    u8 = np.random.default_rng(5).integers(0, 256, (2, 24, 24, 3),
                                           dtype=np.uint8)
    for denoise in (False, True):
        emit(what="preprocess_eval", denoise=denoise, dtype="f32", **gap(
            timg.preprocess_eval(u8, size=16, denoise=denoise, device="cpu"),
            jimg.preprocess_eval(jnp.asarray(u8), size=16, denoise=denoise)))

    images, labels = tpl._pool()
    idx = np.array([3, 1, 4, 1, 5], np.int32)
    emit(what="pool_gather_plain_vs_pallas", dtype="uint8", **gap(
        tgather.pool_gather(torch.from_numpy(images), idx),
        pool_gather(jnp.asarray(images), jnp.asarray(idx), interpret=True)))
    kw = dict(live_mult=3, spoof_mult=2, batch_size=4, seed=7)
    got = list(tpool.DevicePoolData(images, labels, device="cpu",
                                    **kw).batches(1))
    want = list(jpool.DevicePoolData(images, labels, **kw).batches(1))
    emit(what="pool_index_stream", batches=len(got), equal=len(got) == len(
        want) and all(a["group"] == b["group"] and np.array_equal(
            a["index"], b["index"]) for a, b in zip(got, want)))
    images, labels = tpl._pool(n=20, size=32)
    idx = np.array([3, 1, 4, 1], np.int32)
    jstate, port = tts._jax_and_port_states()
    jstep = make_train_step(tts.jl.make_loss_fn("focal"), donate=False,
                            batch_prep=lambda key, u: jimg.normalize(
                                jimg.to_float(u)))
    _, jm = jstep(jstate, {"image": jnp.asarray(images),
                           "index": jnp.asarray(idx),
                           "label": jnp.asarray(labels[idx])})
    pstep = tts.ST.make_train_step(tts.tl.make_loss_fn("focal"),
                                   batch_prep=tpl._prep)
    _, pm = pstep(port, {"image": torch.from_numpy(images), "index": idx,
                         "label": labels[idx]})
    emit(what="pool_train_step.metrics", dtype="f32",
         **{k: abs(float(pm[k]) - float(jm[k]))
            for k in ("loss", "accuracy", "grad_norm")})


def eval():  # noqa: A001 - the section's name on the command line
    """The eval slice: kernel 8's plain version against the JAX Pallas
    kernel (interpret mode), the bf16 and f32 modules against jitted
    flax, ResNet50 with batch_stats, and run_inference's scores on a
    synthetic tree."""
    import tempfile

    import test_torch_resnet as trs
    from util_synthetic import make_subject_tree
    from vit_spoof_detection_pda_tpu.data import scan_test as jscan
    from vit_spoof_detection_pda_tpu.eval import run_inference as jrun
    from vit_spoof_detection_pda_tpu.models.resnet import ResNet50 as JRes
    from vit_spoof_detection_pda_tpu_torch.data.manifest import scan_test
    from vit_spoof_detection_pda_tpu_torch.eval import run_inference
    from vit_spoof_detection_pda_tpu_torch.models import convert as tconv
    from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
    from vit_spoof_detection_pda_tpu_torch.models.resnet import ResNet50

    dts = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
    for dtype, (jdt, tdt) in dts.items():
        for b, t, d, heads in ((2, 17, 64, 4), (3, 33, 64, 4),
                               (3, 197, 768, 12)):
            x = np.random.default_rng(b * 1000 + t).standard_normal(
                (b, t, 3 * d)).astype(np.float32)
            want = jatt.fused_attention_qkv(jnp.asarray(x, jdt), heads, True)
            got = tatt.fused_attention_qkv(torch.tensor(x).to(tdt), heads)
            emit(what="attention_qkv", dtype=dtype, b=b, t=t, d=d,
                 heads=heads, **gap(got.float().numpy(), want))
    geoms = {"small": (dict(patch_size=16, embed_dim=64, depth=2,
                            num_heads=4, hidden=16), 32),
             "vit_b_width": (dict(patch_size=16, embed_dim=768, depth=1,
                                  num_heads=12, hidden=512), 64)}
    for dtype, (jdt, tdt) in dts.items():
        for label, (geom, img) in geoms.items():
            jm = jvit.ViTAntiSpoof(**geom, dtype=jdt)
            v = jm.init(jax.random.PRNGKey(img), jnp.zeros((1, img, img, 3)))
            u8 = np.random.default_rng(img).integers(0, 256, (4, img, img, 3),
                                                     dtype=np.uint8)
            x = (u8 / np.float32(255) - np.float32(0.45)) / np.float32(0.225)
            x = x.astype(np.float32)
            want = jax.jit(jm.apply)(v, jnp.asarray(x))
            tm = tconv.load_jax_params(tvit.ViTAntiSpoof(
                **geom, dtype=tdt, img_size=img).eval(),
                jax.tree.map(np.asarray, v))
            with torch.no_grad():
                got = tm(torch.tensor(x))
            emit(what="vit_antispoof_module", dtype=dtype, geom=label,
                 **gap(got.numpy(), want))
    jrn = JRes()
    rv = jrn.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    x = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(
        np.float32)
    tm = tconv.load_jax_params(ResNet50().eval(), rv)
    with torch.no_grad(), trs.exact_f32_matmul():
        got = tm(torch.tensor(x))
    emit(what="resnet50", dtype="f32",
         **gap(got.numpy(), jax.jit(jrn.apply)(rv, jnp.asarray(x))))
    with tempfile.TemporaryDirectory() as root:
        make_subject_tree(pathlib.Path(root), subjects=3, per_class=4,
                          size=32)
        geom, img = geoms["small"]
        jm = jvit.ViTAntiSpoof(**geom)
        v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        tm = tconv.load_jax_params(tvit.ViTAntiSpoof(**geom, img_size=32),
                                   jax.tree.map(np.asarray, v))
        want = jrun(jm, v, jscan(root), batch_size=5, img_size=32)
        got = run_inference(tm, scan_test(root), batch_size=5, img_size=32)
        emit(what="run_inference.prob1", dtype="f32",
             **gap(got["prob1"], want["prob1"]))


def train_loop():
    """The training-loop slice: the two new MLP modes (kernel 7's plain
    version for "fused") against JAX, the tensor metrics, and the port's
    Trainer against the JAX Trainer per epoch (the sweep and early-stop
    case and the EMA case of tests/test_torch_trainer.py)."""
    import test_torch_mlp_modes as tmm
    import test_torch_trainer as ttr
    from vit_spoof_detection_pda_tpu.config import Config as JConfig
    from vit_spoof_detection_pda_tpu.metrics import device as jdev
    from vit_spoof_detection_pda_tpu.parallel import make_mesh
    from vit_spoof_detection_pda_tpu.train import Trainer as JTrainer
    from vit_spoof_detection_pda_tpu_torch.metrics import device as tdev
    from vit_spoof_detection_pda_tpu_torch.models.convert import (
        train_state_arrays)

    for mode, jfn, jst, tfn in (
            ("xhat", jft.mlp_block_train, (False, 1e-6),
             tft.MlpBlockTrainX.apply),
            ("fused", jft.mlp_block_train_p, (False, 1e-6, True),
             tft.MlpBlockTrainP.apply)):
        out, want_out, got, want = tmm._grads(jfn, jst, tfn, (False, 1e-6),
                                              tmm._args(3), 4)
        emit(what=f"mlp_{mode}.y", dtype="f32", **gap(tmm._np(out),
                                                      want_out))
        for name, g_, w_ in zip(tmm.NAMES, got, want):
            emit(what=f"mlp_{mode}.grad_{name}", dtype="f32",
                 **gap(tmm._np(g_), w_))
    for dtype, jdt, tdt in (("f32", jnp.float32, torch.float32),
                            ("bf16", jnp.bfloat16, torch.bfloat16)):
        args = tmm._args(5, 2, 17)
        y, xh, inv, h = jft._mlp_fwd_pallas(*tmm._jax(args, jdt), False,
                                            1e-6, True)
        ta_ = tmm._torch(args, tdt)
        got = tatt.mlp_block_train_plain(ta_[0].reshape(34, -1), *ta_[1:],
                                         approximate=False)
        for name, g_, w_ in zip(("y", "xhat", "inv", "h"), got,
                                (np.asarray(y, np.float32).reshape(34, -1),
                                 *(np.asarray(a, np.float32)[:34]
                                   for a in (xh, inv, h)))):
            emit(what=f"kernel7_plain.{name}", dtype=dtype,
                 **gap(tmm._np(g_), w_))
    rng = np.random.default_rng(0)
    s, y = rng.random(200).astype(np.float32), rng.integers(0, 2, 200)
    emit(what="metrics.auc", dtype="f32",
         **gap(tdev.auc(torch.tensor(s), torch.tensor(y)),
               jdev.auc(jnp.asarray(s), jnp.asarray(y))))
    emit(what="metrics.threshold_grid", dtype="f32",
         **gap(tdev.threshold_grid(0.3, 0.7, 41), jnp.linspace(0.3, 0.7, 41)))
    for over in ({"optim.num_epochs": 5, "early_stop.patience": 1},
                 {"optim.num_epochs": 2, "optim.ema_decay": 0.5}):
        images, labels = ttr._synthetic(64, seed=1)
        val = ttr._synthetic(48, seed=2)
        tb, vb = ttr._feeds(images, labels, val)
        jlog, tlog = ttr._Log(), ttr._Log()
        jt = JTrainer(JConfig().with_overrides(
            {**ttr.BASE, "model.dropout": 0.0, **over}),
            jvit.ViTAntiSpoof(patch_size=16, dropout=0.0, **ttr.GEOM),
            train_batches=tb, val_batches=vb, steps_per_epoch=4,
            mesh=make_mesh(devices=jax.devices()[:1]), logger=jlog)
        arrays = train_state_arrays(jt.state)
        jt.fit()
        ttr._port(over, images, labels, val, opt_arrays=arrays,
                  logger=tlog).fit()
        for e, (a, b) in enumerate(zip(jlog.epochs(), tlog.epochs())):
            emit(what="trainer_epoch", case=sorted(over)[-1], epoch=e,
                 **{k: {"jax": a[k], "port": b[k],
                        "abs_diff": abs(a[k] - b[k])}
                    for k in ("train/loss", "val/loss", "val/auc",
                              "val/f1", "val/optimal_threshold")})
        emit(what="trainer_epochs_run", case=sorted(over)[-1],
             jax=len(jlog.epochs()), port=len(tlog.epochs()))


def cli():
    """Slice 7: kernel 5's plain path against JAX's phased kernel
    (interpret mode); the ``test`` and ``evaluate-all`` verbs' per-image
    scores against JAX's verbs on the same .pth; the sweep's EI."""
    import tempfile

    import test_torch_attention_phased as tap
    import test_torch_cli_eval as tce
    from util_synthetic import make_subject_tree
    from vit_spoof_detection_pda_tpu.cli import evaluate_all as jev
    from vit_spoof_detection_pda_tpu.cli import test as jtest
    from vit_spoof_detection_pda_tpu.models import convert as jconvert
    from vit_spoof_detection_pda_tpu.train import sweep as jsweep
    from vit_spoof_detection_pda_tpu_torch.cli import evaluate_all as tev
    from vit_spoof_detection_pda_tpu_torch.cli import test as ttest
    from vit_spoof_detection_pda_tpu_torch.train import sweep as tsweep

    saved = jatt.BWD_PHASED
    jatt.BWD_PHASED = True
    try:
        for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                                ("bfloat16", jnp.bfloat16, torch.bfloat16)):
            for b, tp, valid, d, heads in ((2, 16, 13, 32, 2),
                                           (2, 40, 33, 64, 4)):
                qkv, g = tap._inputs(b * tp + d, b, tp, valid, d)
                want = jatt._backward_qkv(
                    jnp.asarray(qkv, jdt), jnp.asarray(g, jdt), heads,
                    interpret=True, valid_len=valid).astype(jnp.float32)
                got = tatt.attention_qkv_bwd_plain(
                    torch.tensor(qkv, dtype=tdt), torch.tensor(g, dtype=tdt),
                    heads, valid_len=valid).float()
                emit(what="attention_qkv_bwd_phased", dtype=dtype,
                     shape=[b, tp, 3 * d], valid_len=valid,
                     **gap(got.numpy(), want))
    finally:
        jatt.BWD_PHASED = saved

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        make_subject_tree(root / "test", subjects=2, per_class=3, size=64)
        params = jax.tree.map(np.asarray, jvit.ViTAntiSpoof().init(
            jax.random.PRNGKey(7), jnp.zeros((1, 224, 224, 3))))["params"]
        params["head"]["fc2"]["kernel"] = params["head"]["fc2"]["kernel"] * 4
        jconvert.save_torch_checkpoint(str(root / "vit.pth"),
                                       {"params": params})
        argv = ["--checkpoint", str(root / "vit.pth"),
                "--set", f'data.test_root="{root / "test"}"', "--no-plots"]
        jtest.main(argv + ["--set", f'eval.output_dir="{root / "j"}"'])
        ttest.main(argv + ["--set", f'eval.output_dir="{root / "t"}"',
                           "--device", "cpu"])
        want = tce._column(tce._only(root / "j", "per_image_results_*.csv"),
                           "probability_live")
        got = tce._column(tce._only(root / "t", "per_image_results_*.csv"),
                          "probability_live")
        emit(what="test_verb_bf16_scores", images=len(want),
             **gap([got[k] for k in want], list(want.values())))
        argv = argv[:-1] + ["--models", "Custom_ViT_FineTuned"]
        jev.main(argv + ["--set", f'eval.output_dir="{root / "je"}"'])
        tev.main(argv + ["--set", f'eval.output_dir="{root / "te"}"',
                         "--device", "cpu"])
        name = "Custom_ViT_FineTuned"
        want = tce._column(root / "je" / name / "per_image_predictions.csv",
                           "spoof_score")
        got = tce._column(root / "te" / name / "per_image_predictions.csv",
                          "spoof_score")
        emit(what="evaluate_all_f32_scores", model=name,
             **gap([got[k] for k in want], list(want.values())))

    rng = np.random.default_rng(0)
    xs, ys, xc = rng.random((7, 11)), rng.random(7), rng.random((512, 11))
    emit(what="sweep_gp_ei", **gap(tsweep._gp_ei(xs, ys, xc),
                                   np.asarray(jsweep._gp_ei(xs, ys, xc))))


def artifact():
    """Slice 8: kernel 9's plain version against JAX's interpret-mode
    kernel; the int8 packs, the int8 lowlat forward and the int8 module
    path against JAX's; a port module artifact against a JAX module
    artifact on the same weights."""
    import tempfile

    import test_torch_artifact as tart
    import test_torch_fused_attention as tfa
    import test_torch_int8 as ti8
    from vit_spoof_detection_pda_tpu.models import artifact as JA
    from vit_spoof_detection_pda_tpu.models import serving as jserv
    from vit_spoof_detection_pda_tpu_torch.models import artifact as A
    from vit_spoof_detection_pda_tpu_torch.models import serving as tserv

    for (jdt, tdt), name in zip(tfa.DTYPES, tfa.DTYPE_IDS):
        for t in (197, 33, 5):
            q, k, v = tfa._qkv(t, 2, t, 4, 16)
            want = jatt.fused_attention(
                *(jnp.asarray(x, jdt) for x in (q, k, v)), True
            ).astype(jnp.float32)
            got = tatt.fused_attention(
                *(torch.from_numpy(x).to(tdt) for x in (q, k, v))).float()
            emit(what="fused_attention", dtype=name, t=t,
                 **gap(got.numpy(), want))
    q, k, v = tfa._qkv(3, 1, 33, 2, 16)
    want = jax.grad(lambda q, k, v: jnp.sum(
        jatt.fused_attention(q, k, v, True) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tatt.fused_attention(tq, tk, tv) ** 2).sum().backward()
    for n, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        emit(what="fused_attention_grad", wrt=n, **gap(g.numpy(), w))

    for geom in ("small", "foldable"):
        g = ti8._geometry(geom)
        for (jdt, tdt), name in zip(ti8.DTYPES, ti8.DTYPE_IDS):
            (jw, js), (tw, ts) = ti8._int8_packs(g, 2, jdt, tdt)
            emit(what="int8_pack", geom=geom, dtype=name,
                 w_bytes_equal=bool((tw.numpy() == np.asarray(jw)).all()),
                 s_bytes_equal=bool((ts.numpy() == np.asarray(js)).all()))
            u8 = np.random.default_rng(9).integers(
                0, 256, (1, g["img"], g["img"], 3), dtype=np.uint8)
            jp = jfast.prepare_lowlat(g["folded"]["params"], depth=2,
                                      dtype=jdt, int8_weights=True)
            tp = tfast.prepare_lowlat(g["np"], depth=2, dtype=tdt,
                                      int8_weights=True, device="cpu")
            kw = dict(num_heads=2, patch_size=g["patch"])
            want = jfast.serving_forward_lowlat(jp, jnp.asarray(u8),
                                                dtype=jdt, interpret=True,
                                                **kw)
            got = tfast.serving_forward_lowlat(tp, u8, dtype=tdt,
                                               device="cpu", **kw)
            emit(what="int8_lowlat_scores", geom=geom, dtype=name,
                 fold_ends="aux" in tp, **gap(got.numpy(), want))

    module = jvit.ViTAntiSpoof(patch_size=8, embed_dim=64, depth=2,
                               num_heads=2, hidden=32)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    x = np.random.default_rng(2).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((128, 64)).astype(np.float32) * 0.05
    b = rng.standard_normal(64).astype(np.float32) * 0.01
    xd = rng.standard_normal((2, 16, 128)).astype(np.float32)
    emit(what="dense_int8", **gap(
        tserv.dense_int8(torch.from_numpy(xd),
                         tserv.quantize_dense(w, b, device="cpu")).numpy(),
        jserv.dense_int8(jnp.asarray(xd), jserv.quantize_dense(w, b))))
    qp = jserv.quantize_vit_params(variables["params"], depth=2)
    tqp = tserv.quantize_vit_params(
        jax.tree.map(np.asarray, variables["params"]), depth=2, device="cpu")
    emit(what="int8_apply_logits", **gap(
        tserv.vit_antispoof_int8_apply(tqp, torch.from_numpy(x),
                                       num_heads=2, patch_size=8).numpy(),
        jserv.vit_antispoof_int8_apply(qp, jnp.asarray(x), num_heads=2,
                                       patch_size=8, interpret=True)))

    jm, variables, tm = tart._models(tart.GEOM, tart.IMG)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        for label, kw in (("default", {}),
                          ("t0.3_T1.7", {"threshold": 0.3,
                                         "temperature": 1.7})):
            JA.save_serving_artifact(root / f"j{label}", jm, variables,
                                     mode="module", img_size=tart.IMG, **kw)
            A.save_serving_artifact(root / f"t{label}", tm, mode="module",
                                    img_size=tart.IMG, **kw)
            ja = JA.load_serving_artifact(root / f"j{label}")
            ta_ = A.load_serving_artifact(root / f"t{label}", device="cpu")
            for bsz in (1, 3, 5):
                u8 = tart._u8(bsz, bsz)
                want, got = ja(jnp.asarray(u8)), ta_(u8)
                emit(what="module_artifact_prob1", case=label, batch=bsz,
                     pred_equal=bool((got["pred"].numpy() == np.asarray(
                         want["pred"])).all()),
                     **gap(got["prob1"].numpy(), want["prob1"]))


def int8_vitb():
    """The int8 module path at ViT-B/16 on chip_smoke.py's slice_int8
    inputs (phase 4's numpy-seeded weights, its 128 faces): the JAX
    package's int8 path (dense attention reference on the CPU) and the
    port's plain int8 path against JAX's f32 module, the JAX test's
    criterion (max |d logit| / std, argmax agreement), and the two int8
    paths against each other.  About a minute on 8 cores."""
    import chip_smoke as cs
    from vit_spoof_detection_pda_tpu.models import serving as jserv
    from vit_spoof_detection_pda_tpu_torch.models import serving as tserv
    from vit_spoof_detection_pda_tpu_torch.ops.image import (normalize,
                                                             to_float)

    params = cs.random_params(np.random.default_rng(cs.SEED + 1))
    u8 = np.random.default_rng(cs.SEED + 81).integers(
        0, 256, (cs.MAIN_B, cs.IMG, cs.IMG, 3), dtype=np.uint8)
    x = normalize(to_float(torch.from_numpy(u8))).numpy()
    jp = jax.tree.map(jnp.asarray, params)
    f32 = jax.jit(lambda p, x: jvit.ViTAntiSpoof().apply(p, x))
    i8 = jax.jit(lambda q, x: jserv.vit_antispoof_int8_apply(q, x))
    qp = jserv.quantize_vit_params(jp["params"])
    tqp = tserv.quantize_vit_params(params["params"], device="cpu")
    chunks = range(0, len(x), 16)
    ref = np.concatenate([np.asarray(f32(jp, jnp.asarray(x[i:i + 16])))
                          for i in chunks])
    jout = np.concatenate([np.asarray(i8(qp, jnp.asarray(x[i:i + 16])))
                           for i in chunks])
    tout = torch.cat([tserv.vit_antispoof_int8_apply(
        tqp, torch.from_numpy(x[i:i + 16])) for i in chunks]).numpy()

    def score(lg):
        return 1.0 / (1.0 + np.exp(-(lg[:, 1] - lg[:, 0])))

    for name, out in (("jax_int8", jout), ("port_plain_int8", tout)):
        emit(what="int8_vitb_vs_jax_f32", path=name, faces=len(x),
             drift_over_std=float(np.abs(out - ref).max() / ref.std()),
             argmax_agreement=float((out.argmax(-1) == ref.argmax(-1))
                                    .mean()))
    emit(what="int8_vitb_port_vs_jax_int8_scores",
         mean_abs=float(np.abs(score(tout) - score(jout)).mean()),
         **gap(score(tout), score(jout)))

    # the int8 lowlat stream (weight-only) on slice_int8's first 64 faces:
    # the port's plain path (equal to JAX's interpret-mode kernel in
    # tests/test_torch_int8.py) against the f32 module, tanh GELU as served
    from vit_spoof_detection_pda_tpu_torch.device import exact_f32_matmul
    from vit_spoof_detection_pda_tpu_torch.models.convert import (
        load_jax_params)
    from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof

    model = load_jax_params(ViTAntiSpoof(gelu="tanh").eval(), params)
    faces = u8[:cs.ARTIFACT_FACES]
    with torch.no_grad(), exact_f32_matmul():
        want = model(torch.from_numpy(x[:len(faces)]))
    want = torch.sigmoid(want[:, 1] - want[:, 0]).numpy()
    got = {}
    for name, int8 in (("bf16", False), ("int8", True)):
        fn = tfast.make_serving_fn(model, batch_size=1, int8_weights=int8,
                                   mode="lowlat", device="cpu")
        got[name] = np.concatenate([fn(faces[i:i + 16]).numpy()
                                    for i in range(0, len(faces), 16)])
        emit(what="lowlat_vitb_vs_f32_module_scores", stream=name,
             faces=len(faces), mean_abs=float(np.abs(got[name] - want)
                                              .mean()),
             **gap(got[name], want))
    emit(what="lowlat_vitb_int8_vs_bf16_scores",
         mean_abs=float(np.abs(got["int8"] - got["bf16"]).mean()),
         **gap(got["int8"], got["bf16"]))


def parallel():
    """Slice 9: kernels 12 and 13's plain versions against JAX's
    fused_attention_qkv_cp (interpret mode) and its VJP, and the
    multi-process runs of tests/test_torch_sequence_parallel.py (SP
    forward, DP 2 x SP 2 step, data-parallel scoring) against JAX's and
    the single-process results."""
    import tempfile

    import test_torch_attention_cp as tcp
    import test_torch_sequence_parallel as tsp

    for dtype in tcp.DTYPES:
        jdt, tdt = tcp.DTYPES[dtype]
        for b, tq, tk, heads, dh, valid in tcp.SHAPES:
            q, kv = tcp._pair(tq * 100 + tk, b, tq, tk, heads, dh)
            want = jatt.fused_attention_qkv_cp(
                jnp.asarray(q, jdt), jnp.asarray(kv, jdt), heads, valid, True)
            got = tatt.fused_attention_qkv_cp_plain(
                torch.tensor(q).to(tdt), torch.tensor(kv).to(tdt), heads,
                valid)
            emit(what="cp_forward_plain_vs_jax_kernel", dtype=dtype,
                 shape=[b, tq, tk, heads, dh, valid],
                 **gap(got.float().numpy(), np.asarray(want, np.float32)))
            g = np.random.default_rng(tq).standard_normal(
                (b, tq, heads * dh)).astype(np.float32)
            wdq, wdkv = tcp._jax_grads(q, kv, g, heads, valid, jdt)
            dq, dkv = tatt.attention_cp_bwd_plain(
                torch.tensor(q).to(tdt), torch.tensor(kv).to(tdt),
                torch.tensor(g).to(tdt), heads, valid)
            for name, a, w in (("dq", dq, wdq), ("dkv", dkv, wdkv)):
                emit(what=f"cp_backward_{name}_plain_vs_jax_vjp",
                     dtype=dtype, shape=[b, tq, tk, heads, dh, valid],
                     pad_keys_zero=not dkv[:, valid:].any().item(),
                     **gap(a.float().numpy(), w))
    with tempfile.TemporaryDirectory() as d:
        runs = tsp.launch(pathlib.Path(d))
        variables = {"params": runs["params"]}
        jm = tsp.JViT(**tsp.JGEOM)
        single = np.asarray(jm.apply(variables, jnp.asarray(runs["x"])))
        for dp, sp, job in ((1, 2, "fwd2"), (2, 2, "fwd4"), (1, 4, "fwd4")):
            got = tsp._assembled(runs["res"], job, dp, sp)
            emit(what="sp_forward_vs_jax_single_device", mesh=[dp, sp],
                 **gap(got, single))
        got = tsp._mesh_step(runs["res"], 0.1)
        loss, params = tsp._port_single_step(runs["params"], runs["x"],
                                             runs["y"], 0.1)
        worst = max(float(np.abs(got["p/" + k] - v).max())
                    for k, v in params.items())
        emit(what="sp_step_dp2_sp2_vs_single_dropout", loss_gap=abs(
            float(got["loss"]) - loss), max_param_abs=worst)
        recs = [tsp.Record(path=str(pathlib.Path(d) / f"face{i}.png"),
                           label=int(lab))
                for i, lab in enumerate(runs["rec_y"])]
        want = tsp.run_inference(tsp.W.module(runs["params"]).eval(), recs,
                                 batch_size=4, img_size=32, num_workers=1)
        emit(what="run_inference_dp2_vs_single",
             **gap(runs["res"]["fwd2_0"]["score/prob1"], want["prob1"]))


def long():  # noqa: A001 - the section's name on the command line
    """Slice 11: the port at T 362 (304 px, 2 heads of 64, depth 2), past
    every one-block kernel limit of the card, against JAX, as
    tests/test_torch_long_shapes.py compares them: the training forward's
    logits and gradient leaves (f32), the bf16 logits, the f32 module
    forward, and the attention core with its backward."""
    import test_torch_long_shapes as tl

    jm, variables, tm = tl._models()
    x = tl._batch()
    labels = np.array([1, 0])
    with jatt.attention_sharding(interpret=True):
        jfn = jft.make_apply(jm)
        want_logits = np.asarray(jfn(variables, jnp.asarray(x)))
        want = jax.grad(lambda p: tl._nll(jfn({"params": p}, jnp.asarray(x)),
                                          jnp.asarray(labels), jnp))(
            variables["params"])
    params = tl._torch_params(variables)
    logits = tft.make_apply(tm, dtype=torch.float32)({"params": params},
                                                     torch.tensor(x))
    emit(what="long_train_logits_f32", **gap(logits.detach().numpy(),
                                              want_logits))
    tl._nll(logits, torch.tensor(labels), torch).backward()
    leaves = tstate.tree_flatten(params)[0]
    wleaves = jax.tree_util.tree_leaves(want)
    emit(what="long_train_grads_f32_worst_leaf", max_abs=max(
        float(np.abs(leaf.grad.numpy() - np.asarray(w)).max())
        for leaf, w in zip(leaves, wleaves)))
    jmb, vb, tmb = tl._models("bf16")
    with jatt.attention_sharding(interpret=True):
        wb = np.asarray(jft.make_apply(jmb)(vb, jnp.asarray(x)), np.float32)
    lb = tft.make_apply(tmb, dtype=torch.bfloat16)(
        {"params": tl._torch_params(vb)}, torch.tensor(x))
    emit(what="long_train_logits_bf16", **gap(lb.detach().numpy(), wb))
    wm = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tl.tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        emit(what="long_module_forward_f32",
             **gap(tm.eval()(torch.tensor(x)).numpy(), wm))
    for dtype, (jdt, tdt) in tl.DT.items():
        q = np.random.default_rng(12).standard_normal(
            (2, tl.T, 3 * tl.D)).astype(np.float32)
        w = np.asarray(jatt.fused_attention_qkv(jnp.asarray(q, jdt), tl.HEADS,
                                                True), np.float32)
        got = tatt.fused_attention_qkv(torch.tensor(q).to(tdt), tl.HEADS)
        emit(what="long_attention_core", dtype=dtype,
             **gap(got.float().numpy(), w))
    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, tl.T, 3 * tl.D)).astype(np.float32)
    g = rng.standard_normal((2, tl.T, tl.D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jatt.fused_attention_qkv(a, tl.HEADS, True),
                     jnp.asarray(q))
    qt = torch.tensor(q, requires_grad=True)
    tatt.fused_attention_qkv(qt, tl.HEADS).backward(torch.tensor(g))
    emit(what="long_attention_core_backward_f32",
         **gap(qt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0])))


if __name__ == "__main__":
    for part in sys.argv[1:] or ("kernels", "serving", "training",
                                 "small_batch", "augment", "eval"):
        globals()[part]()
