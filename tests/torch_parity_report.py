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
from vit_spoof_detection_pda_tpu.models import fastserve as jfast  # noqa: E402
from vit_spoof_detection_pda_tpu.models import vit as jvit  # noqa: E402
from vit_spoof_detection_pda_tpu.ops import attention as jatt  # noqa: E402
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


if __name__ == "__main__":
    kernels()
    serving()
