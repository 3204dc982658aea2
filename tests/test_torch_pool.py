"""The port's pool-mode training feed (train/pool.py, train/online.py,
ops/gather.py, the pool branch of train/step.py) against the JAX
package's.

- index streams (``expand_indices``, ``DevicePoolData.batches``,
  ``OnlineAugmentedData.batches``) equal JAX's for the same seed, exactly;
- kernel 14's plain version equals JAX's ``pool_gather`` (Pallas,
  interpret mode), exactly;
- a pool-mode step equals the same step fed the host-gathered batch, bit
  for bit (the counterpart of tests/test_pool.py's gather equivalence);
- with a draw-free prep (normalize only) one port pool step meets JAX's
  pool ``make_train_step`` at f32 on the same weights: loss and grad_norm
  within 3e-6 (the f32 sums run in another order on each side, as in
  tests/test_torch_train_step.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_train_step import _jax_and_port_states
from util_synthetic import make_subject_tree
from vit_spoof_detection_pda_tpu.data.manifest import scan_raw as j_scan_raw
from vit_spoof_detection_pda_tpu.ops import losses as jl
from vit_spoof_detection_pda_tpu.ops.gather_pallas import pool_gather as j_gather
from vit_spoof_detection_pda_tpu.train import online as JO
from vit_spoof_detection_pda_tpu.train import pool as JPOOL
from vit_spoof_detection_pda_tpu.train.step import make_train_step as j_step
from vit_spoof_detection_pda_tpu_torch.data import manifest as TM
from vit_spoof_detection_pda_tpu_torch.ops import gather as TG
from vit_spoof_detection_pda_tpu_torch.ops import losses as tl
from vit_spoof_detection_pda_tpu_torch.ops.image import normalize, to_float
from vit_spoof_detection_pda_tpu_torch.train import online as TO
from vit_spoof_detection_pda_tpu_torch.train import pool as TPOOL
from vit_spoof_detection_pda_tpu_torch.train import step as TS


def _pool(n=24, size=16, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = (np.arange(n) % 3 == 0).astype(np.int32)    # 1 = live, 1:2
    return images, labels


@pytest.mark.parametrize("live,spoof", [(8, 2), (3, 1), (0, 2)])
def test_expand_indices_equals_jax(live, spoof):
    labels = [1, 0, 0, 1, 0, 1, 1, 0]
    got = TPOOL.expand_indices(labels, live, spoof)
    want = JPOOL.expand_indices(labels, live, spoof)
    assert list(got) == list(want)
    for g in want:
        assert got[g].dtype == np.int32
        np.testing.assert_array_equal(got[g], want[g])


@pytest.mark.parametrize("batch_size,seed", [(4, 7), (5, 0), (32, 1)])
def test_pool_batches_equal_jax(batch_size, seed):
    images, labels = _pool()
    kw = dict(live_mult=3, spoof_mult=2, batch_size=batch_size, seed=seed)
    tdata = TPOOL.DevicePoolData(images, labels, device="cpu", **kw)
    jdata = JPOOL.DevicePoolData(images, labels, **kw)
    assert tdata.steps_per_epoch == jdata.steps_per_epoch
    for epoch, skip in ((0, 0), (1, 0), (0, 3)):
        got = list(tdata.batches(epoch, skip=skip))
        want = list(jdata.batches(epoch, skip=skip))
        assert [b["group"] for b in got] == [b["group"] for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["index"], b["index"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["image"] is tdata.pool


def test_pool_staging_contract(monkeypatch):
    images, labels = _pool(n=10)
    monkeypatch.setattr(TPOOL, "_CHUNK_BYTES", 3 * images[0].nbytes)
    data = TPOOL.DevicePoolData(images, labels, live_mult=1, spoof_mult=1,
                                batch_size=4, device="cpu")
    assert not data.packed and data.row_shape == (16, 16, 3)
    assert data.pool.dtype == torch.uint8 and data.pool.is_contiguous()
    np.testing.assert_array_equal(data.pool.numpy(), images)  # 4 chunks
    prep = object()
    assert data.wrap_prep(prep) is prep
    staged = TPOOL.DevicePoolData(torch.from_numpy(images), labels,
                                  device="cpu")
    assert torch.equal(staged.pool, data.pool)
    with pytest.raises(ValueError, match="length mismatch"):
        TPOOL.DevicePoolData(images, labels[:3], device="cpu")


def test_online_batches_equal_jax(tmp_path):
    make_subject_tree(tmp_path, subjects=2, per_class=5, size=16)
    trecs, jrecs = TM.scan_raw(str(tmp_path)), j_scan_raw(str(tmp_path))
    assert [(r.path, r.label) for r in trecs] == [(r.path, r.label)
                                                  for r in jrecs]
    kw = dict(live_mult=3, spoof_mult=2, batch_size=4, img_size=16,
              num_workers=2, seed=5)
    tdata, jdata = TO.OnlineAugmentedData(trecs, **kw), JO.OnlineAugmentedData(
        jrecs, **kw)
    assert tdata.steps_per_epoch == jdata.steps_per_epoch
    for skip in (0, 2):
        got, want = list(tdata.batches(1, skip=skip)), list(
            jdata.batches(1, skip=skip))
        assert [g for g, _ in got] == [g for g, _ in want]
        for (_, a), (_, b) in zip(got, want):
            for k in ("index", "label", "image"):
                np.testing.assert_array_equal(a[k], b[k])
    groups = TO.expand_records(trecs, 3, 2)
    assert {g: [r.path for r in rs] for g, rs in groups.items()} == {
        g: [r.path for r in rs] for g, rs in JO.expand_records(
            jrecs, 3, 2).items()}


@pytest.mark.parametrize("shape,dtype", [((37, 8, 16, 3), np.uint8),
                                         ((11, 2, 128), np.float32)])
def test_gather_plain_equals_jax_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    pool = (rng.integers(0, 256, shape).astype(dtype) if dtype == np.uint8
            else rng.standard_normal(shape).astype(dtype))
    for b in (8, 5, 1):
        idx = rng.integers(0, shape[0], b).astype(np.int32)
        want = np.asarray(j_gather(jnp.asarray(pool), jnp.asarray(idx),
                                   interpret=True))
        got = TG.pool_gather(torch.from_numpy(pool), idx)
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_checks_indices_on_the_host():
    pool = torch.zeros(5, 4, 4, 3, dtype=torch.uint8)
    with pytest.raises(IndexError, match=r"\[0, 5\)"):
        TG.pool_gather(pool, np.array([0, 5]))
    with pytest.raises(IndexError):
        TG.pool_gather(pool, torch.tensor([-1]))
    with pytest.raises(ValueError, match="1-D integer"):
        TG.pool_gather(pool, np.array([[1]]))
    assert TG.pool_gather(pool, np.array([], np.int32)).shape == (0, 4, 4, 3)


def _prep(gen, u8):
    return normalize(to_float(u8))


def _port_state():
    _, tstate = _jax_and_port_states()
    return tstate


def test_pool_step_equals_the_host_gathered_step_bit_for_bit():
    images, labels = _pool(n=20, size=32)
    idx = np.array([3, 1, 4, 1], np.int32)
    step = TS.make_train_step(tl.make_loss_fn("focal"), batch_prep=_prep)
    s_pool, m_pool = step(_port_state(), {"image": torch.from_numpy(images),
                                          "index": idx,
                                          "label": labels[idx],
                                          "group": "orig"})
    s_host, m_host = step(_port_state(), {"image": images[idx],
                                          "label": labels[idx]})
    for k in ("loss", "accuracy", "grad_norm"):
        assert torch.equal(m_pool[k], m_host[k]), k
    for a, b in zip(s_pool.leaves(), s_host.leaves()):
        assert torch.equal(a, b)


def test_pool_step_matches_jax_f32():
    images, labels = _pool(n=20, size=32)
    idx = np.array([3, 1, 4, 1], np.int32)
    jstate, tstate = _jax_and_port_states()

    def jprep(key, u8):
        from vit_spoof_detection_pda_tpu.ops.image import (
            normalize as jn, to_float as jf)
        return jn(jf(u8))

    jstep = j_step(jl.make_loss_fn("focal"), donate=False, batch_prep=jprep)
    _, jm = jstep(jstate, {"image": jnp.asarray(images),
                           "index": jnp.asarray(idx),
                           "label": jnp.asarray(labels[idx])})
    tstep = TS.make_train_step(tl.make_loss_fn("focal"), batch_prep=_prep)
    _, tm = tstep(tstate, {"image": torch.from_numpy(images), "index": idx,
                           "label": labels[idx]})
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 3e-6, k
    assert float(tm["accuracy"]) == float(jm["accuracy"])
