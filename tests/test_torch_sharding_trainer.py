"""The port's ``Trainer`` under every sharding layout across real
processes (tests/test_sharding_config.py:126-303): gloo groups of 2 and
4 ranks on the CPU, one process per rank running tests/torch_mp_worker.py,
which imports no JAX.  Each rank feeds its data coordinate's rows of the
same global batches (2 epochs of 2 steps at B = 8, f32, AdamW); the
references are the port's one-process ``Trainer`` and the JAX package's
``Trainer`` on one device, here in the pytest process.

- The Trainer builds each layout from ``config.sharding`` alone: the mesh,
  each rank's slices of the parameters and the Adam moments alike (TP:
  qkv's columns of its heads; FSDP: the largest divisible axis; PP: the
  packed tree with depth / pipe layers a stage; TP x PP both).
- The layouts agree on the validation metrics of every epoch: the loss
  within rtol 1e-5 of the one-process run's and 1e-4 of JAX's, the F1
  and AUC within JAX's 0.05 (tests/test_sharding_config.py:290), the
  threshold equal to the one-process run's.
- A pipeline run's checkpoint holds JAX's packed tree, whole; a fresh
  trainer restores its slices and moments bit for bit and trains on;
  the checkpoint reads back in the module layout and scores as the
  trainer's own eval step does.
- A non-ViT module under a pipe axis is refused.
- The ``train`` verb under ``torchrun`` trains in each layout and writes
  whole checkpoints (a pipeline run's packed).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from vit_spoof_detection_pda_tpu.config import Config as JConfig
from vit_spoof_detection_pda_tpu.parallel import make_mesh
from vit_spoof_detection_pda_tpu.parallel import pipeline as jpp
from vit_spoof_detection_pda_tpu.train import Trainer as JTrainer

import torch_mp_common as C
from vit_spoof_detection_pda_tpu_torch.config import Config
from vit_spoof_detection_pda_tpu_torch.train.trainer import Trainer

W = C.W
LAYOUTS = [(2, "tp"), (2, "fsdp"), (2, "pp"), (4, "dp"), (4, "tp"),
           (4, "fsdp"), (4, "pp"), (4, "tp_pp")]
KEYS = ("train/loss", "val/loss", "val/auc", "val/f1",
        "val/optimal_threshold")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer")
    inputs = C.write_inputs(d)
    return {**inputs, "dir": d, "res": C.launch(d, "trainer")}


def _feeds(runs):
    (train_x, train_y), (val_x, val_y) = runs["train"], runs["val"]
    bs = runs["bs"]

    def train_batches(epoch, skip=0):
        idx = np.random.default_rng(epoch).permutation(len(train_x))
        for bi, i in enumerate(range(0, len(train_x) - bs + 1, bs)):
            if bi >= skip:
                yield {"image": train_x[idx[i:i + bs]],
                       "label": train_y[idx[i:i + bs]]}

    def val_batches():
        yield {"image": val_x, "label": val_y}

    return train_batches, val_batches, len(train_x) // bs


@pytest.fixture(scope="module")
def references(runs):
    """Per-epoch metrics of the port's one-process Trainer and JAX's."""
    tb, vb, spe = _feeds(runs)
    log = W.Log()
    Trainer(Config().with_overrides(W.TRAIN_CFG), W.module(runs["params"]),
            train_batches=tb, val_batches=vb, steps_per_epoch=spe,
            variables={"params": runs["params"]}, device="cpu",
            logger=log).fit()
    port = [r for r in log.records if "train/epoch" in r]
    jlog = W.Log()
    JTrainer(JConfig().with_overrides(W.TRAIN_CFG),
             C.JViT(dropout=0.0, **C.JGEOM), train_batches=tb,
             val_batches=vb, steps_per_epoch=spe,
             # a copy: the JAX step donates its state's buffers
             variables={"params": jax.tree.map(np.array, runs["params"])},
             mesh=make_mesh(data=1, model=1, devices=jax.devices()[:1]),
             logger=jlog).fit()
    jax_epochs = [r for r in jlog.records if "train/epoch" in r]
    return port, jax_epochs


def _shapes(o, name):
    pre = f"{name}/shape/"
    return {k[len(pre):]: tuple(v) for k, v in o.items()
            if k.startswith(pre)}


@pytest.mark.parametrize("world,name", LAYOUTS)
def test_trainer_builds_each_layout(runs, world, name):
    want_mesh = {(2, "tp"): (1, 2), (2, "fsdp"): (2, 1), (2, "pp"): (1, 2),
                 (4, "dp"): (4, 1), (4, "tp"): (2, 2), (4, "fsdp"): (4, 1),
                 (4, "pp"): (2, 2), (4, "tp_pp"): (1, 2, 2)}[(world, name)]
    for o in C.ranks(runs["res"], world):
        assert tuple(o[f"{name}/mesh"]) == want_mesh
        shape = _shapes(o, name)
        mu = [tuple(int(v) for v in row if v) for row in o[f"{name}/mu_shapes"]]
        # the moments are born in the parameters' layout
        assert mu == [tuple(s for s in shp if s) for shp in shape.values()]
        if name in ("pp", "tp_pp"):
            assert "vit/block0/attn/qkv/kernel" not in shape
            qkv = shape["vit/blocks/attn/qkv/kernel"]
            assert qkv == ((2, 64, 96) if name == "tp_pp" else (2, 64, 192))
            continue
        qkv = shape["vit/block0/attn/qkv/kernel"]
        fc1 = shape["vit/block0/mlp/fc1/kernel"]
        n = world // 2 if name == "tp" else world
        if name == "tp":
            assert qkv == (64, 96) and fc1 == (64, 128)
        elif name == "fsdp":
            assert qkv == (64, 192 // n) and fc1 == (64, 256 // n)
        else:
            assert qkv == (64, 192) and fc1 == (64, 256)


@pytest.mark.parametrize("world,name", LAYOUTS)
def test_layouts_agree_on_the_validation_metrics(runs, references, world,
                                                 name):
    port, jax_epochs = references
    assert len(port) == len(jax_epochs) == 2
    for o in C.ranks(runs["res"], world):
        for key in KEYS:
            got = o[f"{name}/fit/{key}"]
            one = [e[key] for e in port]
            if key.endswith("loss"):
                np.testing.assert_allclose(got, one, rtol=1e-5, err_msg=key)
                np.testing.assert_allclose(
                    got, [e[key] for e in jax_epochs], rtol=1e-4,
                    err_msg=key)
            elif key.endswith("threshold"):
                assert got.tolist() == one, key
            else:
                np.testing.assert_allclose(
                    got, [e[key] for e in jax_epochs], atol=0.05,
                    err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_checkpoint_is_packed_and_resumes(runs, world):
    outs = C.ranks(runs["res"], world)
    for o in outs:
        assert bool(o["pp/resume_equal"])
        assert int(o["pp/resume_step"]) == 4
        assert np.isfinite(float(o["pp/resume_val_f1"]))
    assert outs[0]["pp/ckpt_files"].tolist() == ["4"]
    payload = torch.load(runs["dir"] / f"pp_resume{world}" / "4" / "state.pt",
                         map_location="cpu", weights_only=True)
    want = jpp.pack_pipeline_params({"params": runs["params"]}, 4)["params"]
    saved = C.flat(jax.tree.map(lambda t: t.numpy(), payload["params"]))
    assert {k: v.shape for k, v in saved.items()} == {
        k: v.shape for k, v in C.flat(want).items()}
    # the whole trained leaves, as the ranks gather them
    for k, v in C.agreed(outs, "pp/full").items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)
    assert len(payload["opt_state"]["mu"]) == len(saved)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_params_unpack_to_the_module_layout(runs, world):
    for o in C.ranks(runs["res"], world):
        assert bool(o["pp/ckpt_unpacked"])
        np.testing.assert_allclose(o["pp/ckpt_logits"], o["pp/eval_logits"],
                                   atol=1e-5)


@pytest.fixture
def world2():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_trainer_pp_rejects_non_vit(world2):
    from vit_spoof_detection_pda_tpu_torch.models.resnet import ResNet50
    cfg = Config().with_overrides({"data.img_size": 16,
                                   "sharding.pipeline_parallel": 2})
    with pytest.raises(ValueError, match="pipeline_parallel"):
        Trainer(cfg, ResNet50(num_classes=2),
                train_batches=lambda e, skip=0: iter(()),
                val_batches=lambda: iter(()), steps_per_epoch=1,
                device="cpu")


VERB_LAYOUTS = {"tp": (2, ["sharding.model_parallel=2"]),
                "fsdp": (2, ["sharding.fsdp=true",
                             "sharding.fsdp_min_size=1024"]),
                "pp": (2, ["sharding.pipeline_parallel=2"]),
                "tp_pp": (4, ["sharding.pipeline_parallel=2",
                              "sharding.model_parallel=2"])}


@pytest.fixture(scope="module")
def verb_runs(tmp_path_factory):
    """The ``train`` verb under ``torchrun`` (gloo, ``--device cpu``) in
    each layout at once, on 24 PNG faces at 32 px, the tiny model from
    ``--set``: each run's exit code, output and checkpoint directory."""
    import subprocess
    import sys

    from PIL import Image

    d = tmp_path_factory.mktemp("verb")
    rng = np.random.default_rng(6)
    for cls, base in (("live", 140), ("spoof", 60)):
        (d / "data" / cls).mkdir(parents=True)
        for i in range(12):
            Image.fromarray((rng.integers(0, 60, (32, 32, 3)) + base).astype(
                np.uint8)).save(d / "data" / cls / f"f{i}.png")
    common = ["model.embed_dim=64", "model.depth=4", "model.num_heads=4",
              "model.head_hidden=32", "data.img_size=32",
              "optim.num_epochs=1", "data.batch_size=8",
              "data.eval_batch_size=8", "data.num_workers=1",
              "model.compute_dtype=float32", "model.pretrained=false",
              "train_aug.enabled=false", f'data.data_root="{d / "data"}"']
    env = {**os.environ, "PYTHONPATH": os.path.dirname(C.HERE)}
    procs = {}
    for name, (n, sets) in VERB_LAYOUTS.items():
        argv = [sys.executable, "-m", "torch.distributed.run",
                "--nproc-per-node", str(n), "--master-port",
                str(C.free_port()), "-m", "vit_spoof_detection_pda_tpu_torch",
                "train", "--device", "cpu", "--max-steps-per-epoch", "2"]
        for item in common + sets + [f'checkpoint.save_dir="{d / name}"']:
            argv += ["--set", item]
        procs[name] = subprocess.Popen(argv, cwd=d, env=env, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    return {name: (p.wait(timeout=300), p.stdout.read(), d / name)
            for name, p in procs.items()}


@pytest.mark.parametrize("name", list(VERB_LAYOUTS))
def test_train_verb_under_torchrun_writes_whole_checkpoints(verb_runs, name):
    code, out, ckpt = verb_runs[name]
    assert code == 0, out[-3000:]
    (step,) = [p for p in ckpt.iterdir() if p.name.isdigit()]
    payload = torch.load(step / "state.pt", map_location="cpu",
                         weights_only=True)
    vit = payload["params"]["vit"]
    if name in ("pp", "tp_pp"):
        assert "block0" not in vit
        assert tuple(vit["blocks"]["attn"]["qkv"]["kernel"].shape) == (
            4, 64, 192)
    else:
        assert tuple(vit["block0"]["attn"]["qkv"]["kernel"].shape) == (
            64, 192)
    assert len(payload["opt_state"]["mu"]) == len(payload["paths"])
