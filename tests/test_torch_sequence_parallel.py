"""The port's data and sequence parallelism across real processes: gloo
groups of 2 and 4 ranks on the CPU (free localhost ports, as
tests/test_multihost.py runs the JAX package's), one process per rank
running tests/torch_sp_worker.py, which imports no JAX.  The JAX side
runs here, in the pytest process, on its 8 virtual CPU devices; inputs
go to the workers and results come back as ``.npz`` files in
``tmp_path``.

Model: ``ViTAntiSpoof(patch_size=8, embed_dim=64, depth=2, num_heads=4,
hidden=32)`` at 32x32, JAX's own sequence-parallel test model
(tests/test_sequence_parallel.py:86): T = 17 tokens, which no sequence
size divides, so every mesh pads and masks.  The JAX tree goes to the
port through ``models/convert.py``.

- Forward at (data, seq) = (1, 2), (2, 2), (1, 4): every rank of a
  sequence group returns the same logits, the data ranks' rows assemble
  into JAX's sequence-parallel forward (``make_seq_mesh``,
  ``attention_sharding(interpret=True)``) and into the single-card
  module's, f32 within atol 2e-5 / rtol 1e-5 (JAX's own tolerance); the
  sequence-parallel dispatch ran once a layer.
- One focal-loss AdamW step at data 2 x seq 2 equals the port's
  single-card step with dropout 0.1 (the masks drawn at the global batch
  shape replay the single-card ones) and, with dropout 0, JAX's
  ``make_train_step(mesh=...)`` step: loss within 1e-5, every parameter
  leaf within atol 5e-5 / rtol 1e-4 (JAX :104-142), except the key third
  of each qkv bias, whose gradient is zero in exact arithmetic and whose
  Adam step normalises rounding noise to +-lr: held to 2 lr
  (tests/test_torch_train_step.py gives the reason).
- ``run_inference(mesh=)`` at data 2: the single-card scores in record
  order (atol 1e-6: the ranks score batches of 2 where one process
  scores batches of 4), the same predictions.
- ``Trainer.fit`` at data 2, 2 epochs of 2 steps: per-epoch losses within
  rtol 1e-5 and thresholds equal to the single-process run's on the same
  global batches, one checkpoint set (rank 0's), and a run preempted
  mid-epoch and resumed from its checkpoint bit-equal to the
  uninterrupted one.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.ops import losses as jl
from vit_spoof_detection_pda_tpu.ops.attention import attention_sharding
from vit_spoof_detection_pda_tpu.parallel import make_seq_mesh, shard_batch
from vit_spoof_detection_pda_tpu.train import make_train_step as j_train_step
from vit_spoof_detection_pda_tpu.train.schedule import make_lr_schedule as j_sched
from vit_spoof_detection_pda_tpu.train.state import (
    create_train_state as j_create, make_optimizer as j_make_optimizer)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_sp_worker as W  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.config import Config  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.data.manifest import Record  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.eval.runner import run_inference  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops.losses import make_loss_fn  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel.dryrun import free_port  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train import schedule, state  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train.step import make_train_step  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, module_tree_apply)
from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager)

JGEOM = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, hidden=32)
LR = 3e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _faces(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(np.int64)
    x = (rng.random((n, 32, 32, 3)) + 0.8 * y[:, None, None, None]).astype(
        np.float32)
    return x, y


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("sp"))


def launch(d):
    """Write the inputs to ``d``, start both worker groups, and return the
    inputs and every rank's outputs once they finish."""
    from PIL import Image

    jm = JViT(**JGEOM)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 32, 32, 3)))["params"]
    np.savez(d / "params.npz", **_flat(params))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 32, 32, 3)).astype(np.float32)
    y = (rng.random(16) < 0.5).astype(np.int64)
    train_x, train_y = _faces(16, 2)
    val_x, val_y = _faces(12, 3)
    rec_y = np.random.default_rng(4).integers(0, 2, 10)
    u8 = np.random.default_rng(5).integers(0, 256, (10, 32, 32, 3),
                                           dtype=np.uint8)
    for i in range(10):
        Image.fromarray(u8[i]).save(d / f"face{i}.png")
    np.savez(d / "data.npz", x=x, y=y, train_x=train_x, train_y=train_y,
             val_x=val_x, val_y=val_y, rec_y=rec_y, bs=8)
    procs = []
    for job, world in (("fwd4", 4), ("fwd2", 2)):
        port = free_port()
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_sp_worker.py"),
                 job, str(r), str(world), str(port), str(d)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append((p.returncode, out))
    for code, out in outs:
        assert code == 0, out[-3000:]
    res = {f"{job}_{r}": dict(np.load(d / f"{job}_rank{r}.npz"))
           for job, world in (("fwd4", 4), ("fwd2", 2))
           for r in range(world)}
    return {"dir": d, "params": params, "x": x, "y": y, "res": res,
            "train": (train_x, train_y), "val": (val_x, val_y),
            "rec_y": rec_y}


def _assembled(res, job, dp, sp):
    """The global logits from the ranks of a (dp, sp) mesh: every seq
    rank of a data group agrees, data groups stack in rank order."""
    key = f"fwd_{dp}x{sp}"
    blocks = []
    for g in range(dp):
        outs = [res[f"{job}_{g * sp + s}"][key] for s in range(sp)]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
        blocks.append(outs[0])
    return np.concatenate(blocks)


@pytest.mark.parametrize("dp,sp,job", [(1, 2, "fwd2"), (2, 2, "fwd4"),
                                       (1, 4, "fwd4")])
def test_sp_forward_matches_jax_and_single_device(runs, dp, sp, job):
    res = runs["res"]
    got = _assembled(res, job, dp, sp)
    for r in range(dp * sp):
        assert int(res[f"{job}_{r}"][f"calls_{dp}x{sp}"]) == JGEOM["depth"]
    jm = JViT(**JGEOM)
    variables = {"params": runs["params"]}
    single = np.asarray(jm.apply(variables, jnp.asarray(runs["x"])))
    mesh = make_seq_mesh(seq=sp, data=dp, devices=jax.devices()[:dp * sp])
    with mesh, attention_sharding(mesh=mesh, interpret=True):
        xb = shard_batch({"image": runs["x"]}, mesh)["image"]
        jsp = np.asarray(jax.jit(lambda v, im: jm.apply(v, im))(variables,
                                                              xb))
    tm = W.module(runs["params"]).eval()
    with torch.no_grad():
        port_single = tm(torch.from_numpy(runs["x"])).numpy()
    for want in (jsp, single, port_single):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def _assert_params_close(got, want, key_bias_atol, **tol):
    assert set(got) == set(want)
    for path in sorted(want):
        g, w = np.ravel(got[path]), np.ravel(want[path])
        if path.endswith("qkv/bias"):
            keys = slice(g.size // 3, 2 * g.size // 3)
            np.testing.assert_allclose(g[keys], w[keys], atol=key_bias_atol,
                                       rtol=0, err_msg=path)
            g, w = np.delete(g, keys), np.delete(w, keys)
        np.testing.assert_allclose(g, w, err_msg=path, **tol)


def _port_single_step(params, x, y, dropout):
    m = W.module(params, dropout)
    st = state.create_train_state(
        m, state.make_optimizer(schedule.make_lr_schedule(LR, 100), **W.OPT),
        seed=0, variables={"params": params},
        apply_fn=module_tree_apply(m), device="cpu")
    st, metrics = make_train_step(make_loss_fn("focal"))(
        st, {"image": x, "label": y})
    return (float(metrics["loss"]),
            W.flat(st.params))


def _mesh_step(res, drop):
    """Rank 0's step outputs, after checking every rank agrees."""
    pre = f"step{drop}/"
    outs = [{k[len(pre):]: v for k, v in res[f"fwd4_{r}"].items()
             if k.startswith(pre)} for r in range(4)]
    for o in outs[1:]:
        assert float(o["loss"]) == float(outs[0]["loss"])
        for k in outs[0]:
            np.testing.assert_array_equal(o[k], outs[0][k])
    assert all(int(o["cp_calls"]) == JGEOM["depth"] for o in outs)
    return outs[0]


def test_sp_step_matches_single_device_with_dropout(runs):
    got = _mesh_step(runs["res"], 0.1)
    loss, params = _port_single_step(runs["params"], runs["x"], runs["y"],
                                     0.1)
    assert float(got["loss"]) == pytest.approx(loss, abs=1e-5)
    _assert_params_close({k[2:]: v for k, v in got.items()
                          if k.startswith("p/")}, params,
                         key_bias_atol=2 * LR, atol=5e-5, rtol=1e-4)


def test_sp_step_matches_jax_mesh_step(runs):
    got = _mesh_step(runs["res"], 0.0)
    jm = JViT(dropout=0.0, **JGEOM)
    tx = j_make_optimizer(j_sched(LR, 100), **W.OPT)
    jstate = j_create(jm, tx, jax.random.PRNGKey(0),
                      input_shape=(1, 32, 32, 3),
                      variables={"params": runs["params"]})
    mesh = make_seq_mesh(seq=2, data=2, devices=jax.devices()[:4])
    batch = {"image": runs["x"], "label": runs["y"].astype(np.int32)}
    with mesh, attention_sharding(mesh=mesh, interpret=True):
        step = j_train_step(jl.make_loss_fn("focal"), mesh=mesh,
                            donate=False)
        jstate, jmetrics = step(jstate, shard_batch(batch, mesh))
    assert float(got["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                               abs=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    port = {k[2:]: v for k, v in got.items() if k.startswith("p/")}
    _assert_params_close(port, _flat(jstate.params), key_bias_atol=2 * LR,
                         atol=5e-5, rtol=1e-4)
    loss, single = _port_single_step(runs["params"], runs["x"], runs["y"],
                                     0.0)
    assert float(got["loss"]) == pytest.approx(loss, abs=1e-5)
    _assert_params_close(port, single, key_bias_atol=2 * LR, atol=5e-5,
                         rtol=1e-4)


def test_run_inference_on_a_data_mesh_keeps_record_order(runs):
    d = runs["dir"]
    recs = [Record(path=str(d / f"face{i}.png"), label=int(lab))
            for i, lab in enumerate(runs["rec_y"])]
    want = run_inference(W.module(runs["params"]).eval(), recs, batch_size=4,
                         img_size=32, num_workers=1)
    for r in range(2):
        got = runs["res"][f"fwd2_{r}"]
        np.testing.assert_array_equal(got["score/labels"], want["labels"])
        np.testing.assert_allclose(got["score/prob1"], want["prob1"],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["score/pred"], want["pred"])


def test_two_rank_trainer_matches_single_process_and_resumes_exactly(runs):
    d = runs["dir"]
    (train_x, train_y), (val_x, val_y) = runs["train"], runs["val"]
    bs = 8

    def train_batches(epoch, skip=0):
        idx = np.random.default_rng(epoch).permutation(len(train_x))
        for bi, i in enumerate(range(0, len(train_x) - bs + 1, bs)):
            if bi >= skip:
                yield {"image": train_x[idx[i:i + bs]],
                       "label": train_y[idx[i:i + bs]]}

    log = W.Log()
    cfg = Config().with_overrides({**W.TRAIN_CFG, "model.dropout": 0.1})
    single = Trainer(cfg, W.module(runs["params"]),
                     train_batches=train_batches,
                     val_batches=lambda: iter([{"image": val_x,
                                                "label": val_y}]),
                     steps_per_epoch=len(train_x) // bs,
                     variables={"params": runs["params"]}, device="cpu",
                     logger=log,
                     checkpoints=CheckpointManager(str(d / "single")))
    single.fit()
    epochs = [r for r in log.records if "train/epoch" in r]
    assert len(epochs) == 2
    for r in range(2):
        got = runs["res"][f"fwd2_{r}"]
        for key in ("train/loss", "val/loss", "val/auc"):
            np.testing.assert_allclose(
                got[f"fit/{key}"], [e[key] for e in epochs], rtol=1e-5,
                atol=1e-7, err_msg=key)
        for key in ("val/optimal_threshold", "val/f1"):
            assert got[f"fit/{key}"].tolist() == [e[key] for e in epochs]
        assert bool(got["preempted"]) and bool(got["resume_bit_equal"])
        assert int(got["resume_step"]) == 3          # epoch 1, batch 1
        assert int(got["full_step"]) == 4
    # one checkpoint set, written by rank 0, as the single process writes
    assert sorted(os.listdir(d / "full")) == sorted(os.listdir(d / "single"))
    assert os.listdir(d / "full")
