"""Shared parts of the model-parallel parity tests (not a test module):
the inputs written from numpy seeds and the JAX package's parameter
trees, the launch of ``tests/torch_mp_worker.py`` ranks, and the JAX
references, which run in the pytest process on its virtual CPU devices.

The model is the JAX pipeline tests' (tests/test_pipeline.py:17): patch
16, embed 64, depth 4, 4 heads, head hidden 32, at 32 px (T = 5 tokens);
``GEOM3`` has 3 heads of 22 (embed 66), which no model axis of 2 or 4
divides.  Both trees come from ``ViTAntiSpoof.init`` and reach the port
through ``models/convert.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.ops import losses as jl
from vit_spoof_detection_pda_tpu.train import make_train_step as j_train_step
from vit_spoof_detection_pda_tpu.train.state import (
    create_train_state as j_create)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mp_worker as W  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel.dryrun import free_port  # noqa: E402

JGEOM = {k: v for k, v in W.GEOM.items() if k != "img_size"}
JGEOM3 = {k: v for k, v in W.GEOM3.items() if k != "img_size"}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def faces(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(np.int64)
    x = (rng.random((n, 32, 32, 3)) + 0.8 * y[:, None, None, None]).astype(
        np.float32)
    return x, y


def write_inputs(d) -> dict:
    """The parameter trees and batches, as ``.npz`` files in ``d``."""
    params = JViT(dropout=0.0, **JGEOM).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    params3 = JViT(dropout=0.0, **JGEOM3).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"]
    np.savez(d / "params.npz", **flat(params))
    np.savez(d / "params3.npz", **flat(params3))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = (np.arange(8) % 2).astype(np.int64)
    train_x, train_y = faces(16, 2)
    val_x, val_y = faces(8, 3)
    np.savez(d / "data.npz", x=x, y=y, train_x=train_x, train_y=train_y,
             val_x=val_x, val_y=val_y, bs=8)
    return {"params": params, "params3": params3, "x": x, "y": y,
            "train": (train_x, train_y), "val": (val_x, val_y), "bs": 8}


def launch(d, job, worlds=(2, 4)) -> dict:
    """Run ``job`` on a gloo group of each size in ``worlds`` at once;
    every rank's outputs by ``"<world>_<rank>"``."""
    procs = []
    for world in worlds:
        port = free_port()
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_mp_worker.py"),
                 job, str(r), str(world), str(port), str(d)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    outs = [(p.returncode, out) for p in procs
            for out in [p.communicate(timeout=300)[0]]]
    for code, out in outs:
        assert code == 0, out[-3000:]
    return {f"{world}_{r}": dict(np.load(d / f"{job}{world}_rank{r}.npz"))
            for world in worlds for r in range(world)}


def ranks(res, world):
    return [res[f"{world}_{r}"] for r in range(world)]


def assembled(outs, key, n_data):
    """The global rows of ``key`` over ranks ordered data-major: the
    ranks of one data group agree bit for bit, the groups stack."""
    per = len(outs) // n_data
    blocks = []
    for g in range(n_data):
        group = outs[g * per:(g + 1) * per]
        for o in group[1:]:
            np.testing.assert_array_equal(o[key], group[0][key])
        blocks.append(group[0][key])
    return np.concatenate(blocks)


def agreed(outs, prefix):
    """``{leaf: value}`` under ``prefix/`` on rank 0, after checking every
    rank holds the same."""
    got = {k[len(prefix) + 1:]: v for k, v in outs[0].items()
           if k.startswith(prefix + "/")}
    assert got, prefix
    for o in outs[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(o[f"{prefix}/{k}"], v, err_msg=k)
    return got


def unpacked(tree):
    """A flat tree with ``vit/blocks/...`` stacked leaves split into
    ``vit/block{i}/...``."""
    out = {}
    for k, v in tree.items():
        if k.startswith("vit/blocks/"):
            for i in range(v.shape[0]):
                out[f"vit/block{i}/{k[len('vit/blocks/'):]}"] = v[i]
        else:
            out[k] = v
    return out


def jax_forward(params, x, geom=JGEOM):
    return np.asarray(JViT(dropout=0.0, **geom).apply({"params": params},
                                                      jnp.asarray(x)))


def jax_ce_grads(params, x, y):
    """``jax.grad`` of the mean CE over the batch, one device (the JAX
    pipeline tests' loss)."""
    jm = JViT(dropout=0.0, **JGEOM)
    tgt = jnp.asarray(y, jnp.int32)

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(tgt.size),
                                                    tgt])

    return flat(jax.jit(jax.grad(loss))(params))


def jax_step(params, x, y):
    """One focal-loss SGD step of JAX's ``make_train_step`` on one device
    (tests/test_parallel.py:80): ``(loss, grad_norm, params)``."""
    import optax
    jm = JViT(dropout=0.0, **JGEOM)
    tx = optax.sgd(W.SGD_LR)
    st = j_create(jm, tx, jax.random.PRNGKey(0), input_shape=(1, 32, 32, 3),
                  variables={"params": params})
    step = j_train_step(jl.make_loss_fn("focal"), donate=False)
    st, m = step(st, {"image": jnp.asarray(x),
                      "label": jnp.asarray(y, jnp.int32)})
    return float(m["loss"]), float(m["grad_norm"]), flat(st.params)


def assert_params_close(got, want, **tol):
    """Leaf by leaf at ``tol``."""
    assert set(got) == set(want)
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **tol)


def port_single_step(params, x, y, dropout):
    """The port's one-process SGD step on the same batch (its dropout
    masks are what every sharded layout must replay)."""
    import torch

    from vit_spoof_detection_pda_tpu_torch.ops.losses import make_loss_fn
    from vit_spoof_detection_pda_tpu_torch.train.step import make_train_step
    m = W.module(params, dropout=dropout)
    st = W.new_state(m, params, tx=W.SGD())
    st, metrics = make_train_step(make_loss_fn("focal"))(
        st, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    return float(metrics["loss"]), W.flat(st.params)
