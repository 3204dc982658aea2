"""Print the port's parity gaps against the JAX package on the CPU, one
JSON line per comparison (the numbers the tests bound).

    python tests/torch_parity_report.py

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
import test_torch_train_step as tts  # noqa: E402
from vit_spoof_detection_pda_tpu.models import fastserve as jfast  # noqa: E402
from vit_spoof_detection_pda_tpu.models import vit as jvit  # noqa: E402
from vit_spoof_detection_pda_tpu.models import fasttrain as jft  # noqa: E402
from vit_spoof_detection_pda_tpu.ops import attention as jatt  # noqa: E402
from vit_spoof_detection_pda_tpu.ops import ln_bwd as jln  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models import fasttrain as tft  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import ln_bwd as tln  # noqa: E402
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


if __name__ == "__main__":
    kernels()
    serving()
    training()
