"""The port's shard store (``data/shards.py``) against the JAX package's:
the same bytes on disk for the same records, each package reusing the
other's store, the same batches; the lock, reuse, intact-check and
orphan cases of tests/test_shards.py; and ``train_from_config`` with
``data.shard_cache`` in both feeds against the JAX driver.

Tolerances: the stores, manifests, indices and images are compared byte
for byte.  The Trainer runs (f32, dropout 0, no augmentation, D 64,
depth 2, 4 heads, 32x32, from one JAX initial state) hold per-epoch
train and validation losses within rtol 1e-4 of JAX's, the bound of
tests/test_torch_trainer.py; the port's shard-fed run equals its
``DataPipeline``-fed run bit for bit.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.config import Config as JConfig
from vit_spoof_detection_pda_tpu.data import loader as jloader
from vit_spoof_detection_pda_tpu.data.manifest import (
    scan_augmented as jscan)
from vit_spoof_detection_pda_tpu.data.shards import ShardStore as JStore
from vit_spoof_detection_pda_tpu.train import driver as jdriver
from vit_spoof_detection_pda_tpu_torch.config import Config
from vit_spoof_detection_pda_tpu_torch.data import loader as tloader
from vit_spoof_detection_pda_tpu_torch.data.manifest import scan_augmented
from vit_spoof_detection_pda_tpu_torch.data.shards import ShardStore
from vit_spoof_detection_pda_tpu_torch.models.convert import (
    train_state_arrays)
from vit_spoof_detection_pda_tpu_torch.train import driver as tdriver
from vit_spoof_detection_pda_tpu_torch.train import trainer as ttrainer

from util_synthetic import make_flat_tree, make_subject_tree

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _records(tmp_path, n=10, size=48):
    make_flat_tree(tmp_path / "store", per_class=n // 2, size=size)
    return (scan_augmented(str(tmp_path / "store")),
            jscan(str(tmp_path / "store")))


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.is_file()}


@pytest.mark.parametrize("resize", ["exact", "shorter"])
def test_both_packages_write_the_same_store(tmp_path, resize):
    recs, jrecs = _records(tmp_path)
    ShardStore.build(recs, str(tmp_path / "t"), img_size=32,
                     resize=resize, shard_size=4, num_workers=2)
    JStore.build(jrecs, str(tmp_path / "j"), img_size=32, resize=resize,
                 shard_size=4, num_workers=2)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == ["images-00000.npy", "images-00001.npy",
                           "images-00002.npy", "shards.json"]
    assert got == want


def test_each_package_reuses_the_others_store(tmp_path):
    recs, jrecs = _records(tmp_path)
    for build, other in ((JStore.build, ShardStore.build),
                         (ShardStore.build, JStore.build)):
        d = tmp_path / f"s_{build.__qualname__.split('.')[0]}"
        build(jrecs if build is JStore.build else recs, str(d),
              img_size=32, resize="exact", shard_size=4)
        stamp = {p.name: p.stat().st_mtime_ns for p in d.iterdir()}
        time.sleep(0.01)
        store = other(recs if other is ShardStore.build else jrecs, str(d),
                      img_size=32, resize="exact", shard_size=4)
        assert len(store) == len(recs)
        assert {p.name: p.stat().st_mtime_ns for p in d.iterdir()} == stamp


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_match_jax_and_the_pipeline(tmp_path, skip, drop_last):
    recs, jrecs = _records(tmp_path)
    store = ShardStore.build(recs, str(tmp_path / "s"), img_size=32,
                             resize="exact", shard_size=4)
    jstore = JStore(str(tmp_path / "s"))
    pipe = tloader.DataPipeline(recs, batch_size=4, img_size=32,
                                resize="exact", shuffle=True,
                                drop_last=drop_last, seed=7)
    got = list(store.batches(4, epoch=2, seed=7, drop_last=drop_last,
                             skip=skip))
    want = list(jstore.batches(4, epoch=2, seed=7, drop_last=drop_last,
                               skip=skip))
    piped = list(pipe.batches(epoch=2, skip=skip))
    assert len(got) == len(want) == len(piped) == \
        store.steps_per_epoch(4, drop_last) - skip
    for g, w, p in zip(got, want, piped):
        for k in ("index", "label", "image"):
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], p[k])
    with pytest.raises(ValueError, match="skip"):
        next(store.batches(4, skip=-1))


def test_gather_equals_decode_image(tmp_path):
    recs, _ = _records(tmp_path)
    store = ShardStore.build(recs, str(tmp_path / "s"), img_size=32,
                             resize="exact", shard_size=4)
    idx = np.array([9, 0, 4, 3, 3])
    want = np.stack([jloader.decode_image(recs[i].path, 32, "exact")
                     for i in idx])
    np.testing.assert_array_equal(store.gather(idx), want)
    np.testing.assert_array_equal(store.labels, [r.label for r in recs])


def test_staleness_rebuild_and_orphans(tmp_path):
    """A changed size or record list rebuilds; a smaller rebuild removes
    the shard files its manifest no longer owns (JAX's orphan sweep)."""
    recs, jrecs = _records(tmp_path)
    d = tmp_path / "s"
    ShardStore.build(recs, str(d), img_size=32, resize="exact",
                     shard_size=4)
    s2 = ShardStore.build(recs, str(d), img_size=24, resize="exact",
                          shard_size=4)
    assert s2.img_size == 24 and s2.gather(np.array([0]))[0].shape == \
        (24, 24, 3)
    s3 = ShardStore.build(recs[:3], str(d), img_size=24, resize="exact",
                          shard_size=4)
    assert len(s3) == 3
    assert sorted(p.name for p in d.glob("images-*.npy")) == \
        ["images-00000.npy"]
    j3 = JStore.build(jrecs[:3], str(tmp_path / "j"), img_size=24,
                      resize="exact", shard_size=4)
    assert _files(d) == _files(tmp_path / "j") and len(j3) == 3


def test_truncated_shard_is_rebuilt(tmp_path):
    recs, _ = _records(tmp_path)
    d = tmp_path / "s"
    ShardStore.build(recs, str(d), img_size=32, resize="exact",
                     shard_size=4)
    shard = d / "images-00001.npy"
    shard.write_bytes(shard.read_bytes()[:-10])
    assert not ShardStore(str(d))._shards_intact()
    store = ShardStore.build(recs, str(d), img_size=32, resize="exact",
                             shard_size=4)
    assert store._shards_intact()
    np.testing.assert_array_equal(
        store.gather(np.array([5]))[0],
        jloader.decode_image(recs[5].path, 32, "exact"))


def test_build_lock_stale_steal(tmp_path):
    recs, _ = _records(tmp_path)
    d = tmp_path / "s"
    d.mkdir()
    lock = d / ".building.lock"
    lock.write_text("12345")
    os.utime(lock, (0, 0))
    store = ShardStore.build(recs, str(d), img_size=32, resize="exact",
                             build_timeout=1.0)
    assert len(store) == len(recs) and not lock.exists()


def _release_after(lock, seconds=0.6):
    def release():
        time.sleep(seconds)
        lock.unlink()
    t = threading.Thread(target=release)
    t.start()
    return t


def test_build_lock_adopts_a_concurrent_build(tmp_path):
    recs, _ = _records(tmp_path)
    d = tmp_path / "s"
    ShardStore.build(recs, str(d), img_size=32, resize="exact")
    lock = d / ".building.lock"
    lock.write_text("99999")
    t = _release_after(lock)
    store = ShardStore.build(recs, str(d), img_size=32, resize="exact",
                             build_timeout=30.0)
    t.join()
    assert len(store) == len(recs)


def test_build_lock_foreign_store_raises(tmp_path):
    recs, _ = _records(tmp_path)
    d = tmp_path / "s"
    ShardStore.build(recs, str(d), img_size=32, resize="exact")
    lock = d / ".building.lock"
    lock.write_text("99999")
    t = _release_after(lock)
    with pytest.raises(RuntimeError, match="DIFFERENT record list"):
        ShardStore.build(recs[:4], str(d), img_size=32, resize="exact",
                         build_timeout=30.0)
    t.join()


def test_crashed_builder_recovery_and_no_paths(tmp_path):
    recs, _ = _records(tmp_path)
    d = tmp_path / "s"
    d.mkdir()
    (d / "images-00000.npy").write_bytes(b"garbage")
    store = ShardStore.build(recs, str(d), img_size=16, resize="exact",
                             shard_size=8, num_workers=2)
    assert len(store) == len(recs)
    meta = json.loads((d / "shards.json").read_text())
    assert "paths" not in meta and meta["n"] == len(recs)


# --------------------------------------------------------------------------
# train_from_config with data.shard_cache, against the JAX driver
# --------------------------------------------------------------------------

BASE = {"data.img_size": 32, "data.batch_size": 8, "data.eval_batch_size": 8,
        "data.num_workers": 2, "model.embed_dim": 64, "model.depth": 2,
        "model.num_heads": 4, "model.head_hidden": 16,
        "model.compute_dtype": "float32", "model.dropout": 0.0,
        "train_aug.enabled": False, "optim.num_epochs": 2,
        "optim.learning_rate": 1e-3, "optim.warmup_epochs": 0,
        "threshold.optimize": False, "telemetry.jsonl_path": None,
        "telemetry.log_interval": 100}


class _Log:
    def __init__(self):
        self.records = []

    def log(self, record, step=None):
        self.records.append(dict(record))

    def epochs(self, key):
        return [r[key] for r in self.records if "train/epoch" in r]


def _run_both(tmp_path, monkeypatch, over):
    """The JAX driver's run with a logger of its own; returns its initial
    state's arrays (for the port's run) and the log."""
    captured, jlog = {}, _Log()

    class JTrainer(jdriver.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "logger": jlog})
            captured["arrays"] = train_state_arrays(self.state)

    monkeypatch.setattr(jdriver, "Trainer", JTrainer)
    jdriver.train_from_config(JConfig().with_overrides(
        {**BASE, **over, "checkpoint.save_dir": str(tmp_path / "jck")}))
    return captured["arrays"], jlog


def _port_run(tmp_path, monkeypatch, over, arrays, name):
    tlog = _Log()
    base_trainer = ttrainer.Trainer

    class TTrainer(base_trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "logger": tlog,
                                    "opt_arrays": arrays})

    monkeypatch.setattr(ttrainer, "Trainer", TTrainer)
    _, trainer = tdriver.train_from_config(Config().with_overrides(
        {**BASE, **over, "checkpoint.save_dir": str(tmp_path / name)}),
        device="cpu")
    monkeypatch.setattr(ttrainer, "Trainer", base_trainer)
    return tlog, trainer


def _close_losses(jlog, tlog):
    for key in ("train/loss", "val/loss"):
        want, got = jlog.epochs(key), tlog.epochs(key)
        assert len(got) == len(want) == BASE["optim.num_epochs"]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_records_feed_from_the_shard_cache_matches_jax(tmp_path,
                                                       monkeypatch):
    make_flat_tree(tmp_path / "store", per_class=16, size=40)
    cache = tmp_path / "cache"
    over = {"data.data_root": str(tmp_path / "store"),
            "data.shard_cache": str(cache)}
    arrays, jlog = _run_both(tmp_path, monkeypatch, over)
    stamp = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()}
    tlog, shard_fed = _port_run(tmp_path, monkeypatch, over, arrays, "t1")
    # the port reused the store the JAX driver built
    assert {p.name: p.stat().st_mtime_ns for p in cache.iterdir()} == stamp
    _close_losses(jlog, tlog)
    _, piped = _port_run(tmp_path, monkeypatch,
                         {**over, "data.shard_cache": None}, arrays, "t2")
    for a, b in zip(shard_fed.state.leaves(), piped.state.leaves()):
        assert torch.equal(a, b)


def test_pool_feed_from_the_shard_cache_matches_jax(tmp_path, monkeypatch):
    make_subject_tree(tmp_path / "raw", subjects=2, per_class=8, size=32)
    over = {"augment.online": True, "augment.device_pool": True,
            "augment.input_dir": str(tmp_path / "raw"),
            "augment.live_augmentations": 0,
            "augment.spoof_augmentations": 0,
            "data.shard_cache": str(tmp_path / "cache")}
    arrays, jlog = _run_both(tmp_path, monkeypatch, over)
    tlog, trainer = _port_run(tmp_path, monkeypatch, over, arrays, "t1")
    assert (tmp_path / "cache" / "pool" / "shards.json").exists()
    _close_losses(jlog, tlog)
    assert trainer.state.step == 2 * trainer.steps_per_epoch


def test_each_rank_keeps_its_own_store_directory(monkeypatch):
    from vit_spoof_detection_pda_tpu_torch.parallel import mesh as pm

    assert tdriver._shard_dir("c") == "c"
    monkeypatch.setattr(pm, "world_size", lambda: 4)
    monkeypatch.setattr(pm, "rank", lambda: 3)
    assert tdriver._shard_dir("c/pool") == "c/pool/host3"
