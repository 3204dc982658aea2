"""The port's Trainer (train/trainer.py) against the JAX package's, on the
same weights and batches, at f32 with dropout off and no augmentation, at
a small geometry (D 64, 4 heads, depth 2, head hidden 16, 32x32 images);
and its fit-loop mechanics (mid-epoch resume, preemption, SIGTERM, group
tags), mirroring tests/test_train.py and tests/test_resume_midepoch.py.

The JAX side runs its module forward on a one-device mesh (its fused
forward engages only on a TPU); the port runs its fused training forward
(the kernels' plain versions on the CPU), which
tests/test_torch_fasttrain.py holds against JAX leaf by leaf.  Both
start from one JAX ``TrainState`` (the port through
``models/convert.py::train_state_arrays``).

Tolerances, beside their reasons:
- per-epoch train and val losses, AUC and the sweep's best F1: rtol 1e-4
  (f32; the sums run in other orders, and three epochs of AdamW carry
  the difference forward: the key third of each qkv bias moves by
  +-lr on rounding noise on either side, see
  tests/test_torch_train_step.py, and changes no output);
- counts: equal (a flip would need a score within ~1e-6 of a threshold);
- the sweep's thresholds, and so the chosen one: within one f32 ulp
  (``jnp.linspace``'s last bit follows XLA's fusion of its arithmetic);
- the early-stop epoch: equal.
"""

import signal

import numpy as np
import pytest
import torch

import jax

from vit_spoof_detection_pda_tpu.config import Config as JConfig
from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.parallel import make_mesh
from vit_spoof_detection_pda_tpu.train import Trainer as JTrainer
from vit_spoof_detection_pda_tpu_torch.config import Config
from vit_spoof_detection_pda_tpu_torch.models.convert import (
    train_state_arrays)
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof as TViT
from vit_spoof_detection_pda_tpu_torch.train import Trainer
from vit_spoof_detection_pda_tpu_torch.train.state import tree_flatten
from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (
    CheckpointManager)

GEOM = dict(embed_dim=64, depth=2, num_heads=4, hidden=16)
BS = 16
BASE = {"data.img_size": 32, "telemetry.log_interval": 100,
        "model.compute_dtype": "float32", "optim.learning_rate": 1e-3,
        "optim.warmup_epochs": 0}


def _synthetic(n, seed):
    """Images whose class moves their mean brightness (learnable)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n).astype(np.int32)
    base = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    return base + labels[:, None, None, None] * np.float32(0.5), labels


def _feeds(images, labels, val, preempt=None):
    """Seeded per-epoch order with skip support; ``preempt=((epoch,
    batch), ref)`` calls ``ref[0].request_preemption()`` when about to
    yield that batch (the deterministic stand-in for SIGTERM)."""
    n = len(images)

    def train_batches(epoch, skip=0):
        idx = np.random.default_rng(epoch).permutation(n)
        for bi, i in enumerate(range(0, n - BS + 1, BS)):
            if bi < skip:
                continue
            if preempt is not None and (epoch, bi) == preempt[0]:
                preempt[1][0].request_preemption()
            j = idx[i:i + BS]
            yield {"image": images[j], "label": labels[j]}

    def val_batches():
        for i in range(0, len(val[0]), 24):
            yield {"image": val[0][i:i + 24], "label": val[1][i:i + 24]}

    return train_batches, val_batches


class _Log:
    """Records every log call (the MetricLogger interface)."""

    def __init__(self, on_val=None):
        self.records, self.on_val = [], on_val

    def log(self, record, step=None):
        self.records.append(dict(record))
        if self.on_val and any(k.startswith("val/") for k in record):
            self.on_val()

    def epochs(self):
        return [r for r in self.records if "train/epoch" in r]


def _port(cfg_over, images, labels, val, *, opt_arrays=None, logger=None,
          checkpoints=None, preempt=None, dropout=0.0):
    cfg = Config().with_overrides({**BASE, "model.dropout": dropout,
                                   **cfg_over})
    tb, vb = _feeds(images, labels, val, preempt)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)                     # one initial model
        module = TViT(img_size=32, dropout=dropout, **GEOM)
    return Trainer(cfg, module, train_batches=tb, val_batches=vb,
                   steps_per_epoch=len(images) // BS, device="cpu",
                   opt_arrays=opt_arrays, logger=logger or _Log(),
                   checkpoints=checkpoints)


@pytest.mark.parametrize("over", [
    # up to five epochs, the 41-point sweep, patience 1: stops when F1
    # stalls
    {"optim.num_epochs": 5, "early_stop.patience": 1},
    # EMA on: validation and best-checkpoint selection on the shadow
    {"optim.num_epochs": 2, "optim.ema_decay": 0.5},
], ids=["sweep_early_stop", "ema"])
def test_trainer_matches_jax_trainer(over):
    images, labels = _synthetic(64, seed=1)
    val = _synthetic(48, seed=2)
    jcfg = JConfig().with_overrides({**BASE, "model.dropout": 0.0, **over})
    tb, vb = _feeds(images, labels, val)
    jlog = _Log()
    jt = JTrainer(jcfg, JViT(patch_size=16, dropout=0.0, **GEOM),
                  train_batches=tb, val_batches=vb,
                  steps_per_epoch=len(images) // BS,
                  mesh=make_mesh(devices=jax.devices()[:1]), logger=jlog)
    arrays = train_state_arrays(jt.state)        # the JAX initial state
    jbest = jt.fit()

    tlog = _Log()
    tt = _port(over, images, labels, val, opt_arrays=arrays, logger=tlog)
    tbest = tt.fit()

    je, te = jlog.epochs(), tlog.epochs()
    assert len(je) == len(te) >= 2                # same early-stop epoch
    if "early_stop.patience" in over:
        assert len(te) < over["optim.num_epochs"]      # it did stop early
    for a, b in zip(je, te):
        for k in ("train/loss", "val/loss", "val/auc", "val/optimal_f1"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        for k in ("val/tp", "val/tn", "val/fp", "val/fn", "val/optimal_tp",
                  "val/epoch"):
            assert b[k] == a[k], k
        np.testing.assert_array_max_ulp(np.float32(b["val/optimal_threshold"]),
                                        np.float32(a["val/optimal_threshold"]),
                                        1)
    assert tbest["epoch"] == jbest["epoch"]
    sweeps = [[r for r in log.records if "threshold_sweep/f1" in r]
              for log in (jlog, tlog)]
    assert len(sweeps[0]) == len(sweeps[1]) == 41 * len(je)
    # the grids agree within one f32 ulp (metrics/device.py::threshold_grid)
    np.testing.assert_array_max_ulp(
        np.float32([r["threshold_sweep/threshold"] for r in sweeps[1]]),
        np.float32([r["threshold_sweep/threshold"] for r in sweeps[0]]), 1)
    assert int(tt.state.step) == int(jt.state.step)


def test_midepoch_resume_is_bit_exact(tmp_path):
    """Preempt at epoch 1 / batch 2, checkpoint, resume at exactly that
    position: the final parameters and optimizer state equal an
    uninterrupted run's bit for bit (the dropout generators derive from
    the step, the shuffles are seeded).  Dropout 0.1 and EMA on."""
    images, labels = _synthetic(80, seed=9)
    val = _synthetic(24, seed=10)
    spe = len(images) // BS                      # 5 batches an epoch
    over = {"optim.num_epochs": 3, "optim.ema_decay": 0.9}

    full = _port(over, images, labels, val, dropout=0.1)
    full.fit()

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    ref = [None]
    t_a = _port(over, images, labels, val, dropout=0.1, checkpoints=mgr,
                preempt=((1, 2), ref))
    ref[0] = t_a
    best = t_a.fit()
    assert best.get("preempted") is True
    step = mgr.latest_step()
    assert step == spe + 2                       # epoch 0 + 2 batches
    assert mgr.restore_data_position(step) == {
        "epoch": 1, "batch": 2, "steps_per_epoch": spe}

    t_b = _port(over, images, labels, val, dropout=0.1)
    t_b.state = mgr.restore(t_b.state)
    t_b.fit(start_epoch=step // spe, start_batch=step % spe)
    for a, b, path in zip(full.state.leaves(), t_b.state.leaves(),
                          full.state.paths):
        assert torch.equal(a, b), path
    for key in ("mu", "nu", "ema"):
        for a, b in zip(full.state.opt_state[key], t_b.state.opt_state[key]):
            assert torch.equal(a, b), key
    assert t_b.state.step == full.state.step


def test_trainer_source_without_skip_raises():
    """The Trainer calls train_batches(epoch, skip=n): a source without
    the keyword is a fault of the caller and raises, rather than being
    re-read from the start."""
    images, labels = _synthetic(48, seed=4)
    val = _synthetic(16, seed=5)
    t = _port({"optim.num_epochs": 1}, images, labels, val)

    def train_batches(epoch):                     # no skip kwarg
        for i in range(0, len(images) - BS + 1, BS):
            yield {"image": images[i:i + BS], "label": labels[i:i + BS]}

    t.train_batches = train_batches
    with pytest.raises(TypeError, match="skip"):
        t.fit(start_epoch=0, start_batch=2)
    assert t.state.step == 0


def test_trainer_unknown_group_tag_raises():
    images, labels = _synthetic(32, seed=4)
    t = _port({"optim.num_epochs": 1}, images, labels, (images, labels))
    t.train_steps = {"orig": t.train_steps[None]}
    t.train_batches = lambda epoch, skip=0: iter([
        {"image": images[:16], "label": labels[:16], "group": "mystery"}])
    with pytest.raises(KeyError, match="mystery"):
        t.train_epoch(0)


def test_preemption_checkpoints_and_exits(tmp_path):
    """request_preemption() makes fit() checkpoint at the next safe point
    and return with the preempted flag; the pinned checkpoint survives
    best-k retention and restores into a fresh trainer."""
    images, labels = _synthetic(64, seed=5)
    val = _synthetic(16, seed=6)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    ref = []
    trainer = _port({"optim.num_epochs": 50}, images, labels, val,
                    checkpoints=mgr,
                    logger=_Log(on_val=lambda: ref[0].request_preemption()))
    ref.append(trainer)
    best = trainer.fit()
    assert best.get("preempted") is True and best["epoch"] <= 1
    step = mgr.latest_step()
    assert step is not None and step >= 1
    fresh = _port({"optim.num_epochs": 50}, images, labels, val)
    assert mgr.restore(fresh.state).step == step
    assert torch.equal(fresh.state.leaves()[0], trainer.state.leaves()[0])


def test_preemption_signal_handler_installed_and_restored(tmp_path):
    images, labels = _synthetic(16, seed=6)
    seen = {}

    class Spy(_Log):
        def log(self, record, step=None):
            seen.setdefault("handler", signal.getsignal(signal.SIGTERM))

    before = signal.getsignal(signal.SIGTERM)
    trainer = _port({"optim.num_epochs": 1}, images, labels,
                    (images, labels), logger=Spy(),
                    checkpoints=CheckpointManager(str(tmp_path / "c")))
    trainer.fit()
    assert signal.getsignal(signal.SIGTERM) == before    # restored
    assert seen["handler"] != before                     # was swapped
    seen["handler"](None, None)                          # -> the flag
    assert trainer._preempt.is_set()


def test_preemption_flag_clears_between_fits():
    """A stale request (a cancelled eviction) must not make the next fit()
    exit at batch 0 untrained."""
    images, labels = _synthetic(32, seed=7)
    trainer = _port({"optim.num_epochs": 1}, images, labels,
                    (images, labels))
    trainer.request_preemption()
    best = trainer.fit()
    assert "preempted" not in best
    assert trainer.state.step == 2


def test_parallel_and_profile_settings_raise(tmp_path):
    """The parallel settings that need more ranks than this one process
    fail on the rank count, with JAX's messages (the layouts themselves
    train in tests/test_torch_sharding_trainer.py); ``telemetry.
    profile_dir`` does not raise: the first epoch is traced into it
    (utils/profiling.py)."""
    images, labels = _synthetic(16, seed=8)
    for over, match in (
            ({"sharding.model_parallel": 2}, "not divisible by model=2"),
            ({"sharding.fsdp": True, "sharding.data_parallel": 2},
             "2x1 != 1 devices"),
            ({"sharding.pipeline_parallel": 2},
             "not divisible by pipe\\*model=2")):
        with pytest.raises(ValueError, match=match):
            _port(over, images, labels, (images, labels))
    trace_dir = tmp_path / "trace"
    trainer = _port({"telemetry.profile_dir": str(trace_dir),
                     "optim.num_epochs": 1}, images, labels,
                    (images, labels))
    trainer.fit()
    assert (trace_dir / "trace.json").stat().st_size > 0


def test_jax_train_state_carries_across_with_moments():
    """A JAX TrainState one epoch in (AdamW moments and EMA non-zero)
    loads into the port's state leaf for leaf, and one more epoch on each
    side gives the same parameters within 1e-5 (a few f32 ulps of Adam's
    lr-sized steps; the qkv key-bias third excepted, as in
    tests/test_torch_train_step.py)."""
    images, labels = _synthetic(32, seed=11)
    over = {"optim.num_epochs": 2, "optim.ema_decay": 0.5}
    jcfg = JConfig().with_overrides({**BASE, "model.dropout": 0.0, **over})
    tb, vb = _feeds(images, labels, (images, labels))
    jt = JTrainer(jcfg, JViT(patch_size=16, dropout=0.0, **GEOM),
                  train_batches=tb, val_batches=vb, steps_per_epoch=2,
                  mesh=make_mesh(devices=jax.devices()[:1]), logger=_Log())
    jt.train_epoch(0)
    arrays = train_state_arrays(jt.state)
    tt = _port(over, images, labels, (images, labels), opt_arrays=arrays)
    assert tt.state.step == 2 and tt.state.opt_state["count"] == 2
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jt.state.params)]
    for a, b in zip(tt.state.leaves(), jleaves):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for mine, theirs in zip(tt.state.opt_state["ema"], arrays["ema"]):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    jt.train_epoch(1)
    tt.train_epoch(1)
    for (path, a), b in zip(zip(tt.state.paths, tt.state.leaves()),
                            jax.tree.leaves(jt.state.params)):
        got, want = a.detach().numpy(), np.asarray(b)
        if path[-2:] == ("qkv", "bias"):
            d = got.shape[0] // 3
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(
                want, np.s_[d:2 * d])
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=str(path))
    assert len(tree_flatten(tt.state.params)[0]) == len(jleaves)


def test_train_from_config_trains_checkpoints_and_resumes(tmp_path):
    """The driver end to end on the CPU: a flat augmented store of PNGs,
    the train-time chain inside the step, validation, best-k checkpoints,
    then ``checkpoint.resume`` continuing from the latest step."""
    from util_synthetic import make_flat_tree

    from vit_spoof_detection_pda_tpu_torch.train import train_from_config

    root = make_flat_tree(tmp_path / "store", per_class=12, size=36)
    over = {"data.data_root": str(root), "data.img_size": 32,
            "data.batch_size": 8, "data.eval_batch_size": 8,
            "data.num_workers": 2, "data.train_split": 0.75,
            "train_aug.resize_to": 36, "train_aug.crop_size": 32,
            "model.embed_dim": 64, "model.depth": 2, "model.num_heads": 4,
            "model.head_hidden": 16, "optim.num_epochs": 2,
            "checkpoint.save_dir": str(tmp_path / "ckpt"),
            "checkpoint.max_to_keep": 1, "telemetry.log_interval": 100}
    cfg = Config().with_overrides(over)
    best, trainer = train_from_config(cfg, device="cpu")
    assert best["epoch"] in (0, 1) and 0.3 <= best["optimal_threshold"] <= 0.7
    spe = trainer.steps_per_epoch
    assert trainer.state.step == 2 * spe
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert len(mgr.all_steps()) == 1              # max_to_keep
    resumed = Config().with_overrides({**over, "optim.num_epochs": 3,
                                       "checkpoint.resume": True})
    _, t2 = train_from_config(resumed, device="cpu")
    assert t2.state.step == 3 * spe               # the horizon is kept
    # data.shard_cache: the same run fed from the shard store it builds
    _, t3 = train_from_config(Config().with_overrides(
        {**over, "data.shard_cache": str(tmp_path / "s"),
         "checkpoint.save_dir": str(tmp_path / "ckpt3")}), device="cpu")
    assert (tmp_path / "s" / "shards.json").exists()
    assert t3.state.step == 2 * spe


def test_determinism_controls():
    from vit_spoof_detection_pda_tpu_torch.utils.determinism import (
        seed_everything, strict_determinism)

    g = seed_everything(5)
    a = torch.rand(3, generator=g)
    assert torch.equal(a, torch.rand(3, generator=torch.Generator()
                                     .manual_seed(5)))
    b = torch.rand(3)
    seed_everything(5)
    assert torch.equal(b, torch.rand(3))
    before = torch.are_deterministic_algorithms_enabled()
    with strict_determinism():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
    assert torch.are_deterministic_algorithms_enabled() == before
