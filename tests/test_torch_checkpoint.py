"""The port's checkpoints (utils/checkpoint.py) and reference-format
``.pth`` files (models/convert.py), against the JAX package where the two
share a format: round trip, best-k retention, overwrite and
non-monotonic saves, async saves, ``load_checkpoint_bundle``, the
registry on checkpoint directories and on ``.pth`` files whose metrics
hold numpy values, and JAX Orbax directories read through ``orbax``.
Everything is compared bit for bit: checkpoints copy tensors."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.models import convert as jconvert
from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import registry as treg
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof as TViT
from vit_spoof_detection_pda_tpu_torch.ops import losses as tl
from vit_spoof_detection_pda_tpu_torch.train import state as S
from vit_spoof_detection_pda_tpu_torch.train import step as ST
from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (
    CheckpointManager, list_checkpoints, load_checkpoint_bundle,
    load_params_from_dir)

GEOM = dict(embed_dim=64, depth=2, num_heads=4, hidden=16)


def _state(seed=0, ema=0.9, steps=1):
    """A port TrainState a few AdamW steps in (non-zero moments, EMA)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        tm = TViT(img_size=32, dropout=0.0, **GEOM)
    st = S.create_train_state(tm, S.make_optimizer(1e-3, ema_decay=ema),
                              seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"image": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             "label": np.array([0, 1], np.int32)}
    step = ST.make_train_step(tl.make_loss_fn("focal"))
    for _ in range(steps):
        st, _ = step(st, batch)
    return st


def _equal_states(a, b):
    assert a.step == b.step and a.seed == b.seed and a.paths == b.paths
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)
    for key in ("mu", "nu", "ema"):
        for x, y in zip(a.opt_state[key] or [], b.opt_state[key] or []):
            assert torch.equal(x, y)
    assert a.opt_state["count"] == b.opt_state["count"]


def test_round_trip_restores_the_whole_state(tmp_path):
    st = _state(steps=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, st, metrics={"val_f1": np.float32(0.5), "epoch": 0},
             config={"seed": 1}, data={"epoch": 0, "batch": 2})
    fresh = _state(seed=0, steps=0)
    assert fresh.step == 0
    mgr.restore(fresh)
    _equal_states(fresh, st)
    assert mgr.restore_metrics() == {"val_f1": 0.5, "epoch": 0}
    assert mgr.restore_data_position() == {"epoch": 0, "batch": 2}
    with pytest.raises(ValueError, match="EMA|ema"):
        mgr.restore(_state(ema=None, steps=0))
    # every file reads under weights_only=True
    torch.load(str(tmp_path / "2" / "state.pt"), weights_only=True)


def test_best_k_retention_keeps_the_best_and_pinned(tmp_path):
    st = _state(steps=0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step, f1 in ((1, 0.3), (2, 0.9), (3, 0.1), (4, 0.9), (5, 0.5)):
        mgr.save(step, st, metrics={"val_f1": f1})
    assert mgr.all_steps() == [2, 4]            # ties keep the newer too
    assert mgr.best_step() == 4
    mgr.save(6, st, metrics={"val_f1": 0.0}, pin=True)
    mgr.save(7, st, metrics={"val_f1": 0.95})
    assert mgr.all_steps() == [4, 6, 7]          # 6 pinned, 2 evicted
    mgr_min = CheckpointManager(str(tmp_path / "min"), max_to_keep=1,
                                best_metric="loss", best_mode="min")
    for step, loss in ((1, 0.5), (2, 0.2), (3, 0.4)):
        mgr_min.save(step, st, metrics={"loss": loss})
    assert mgr_min.all_steps() == [2]


def test_overwrite_and_non_monotonic_saves(tmp_path):
    """A fresh run into a used directory neither crashes on an existing
    step nor is skipped below the latest (JAX tests/test_train.py)."""
    old, new = _state(seed=0, steps=0), _state(seed=7, steps=0)
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    assert mgr.save(5, old, metrics={"val_f1": 0.1, "epoch": 0})
    assert mgr.save(9, old, metrics={"val_f1": 0.2, "epoch": 1})
    assert mgr.save(5, new, metrics={"val_f1": 0.3, "epoch": 0})
    # below every step but the overwritten one: the old run's 9 is stale
    assert mgr.all_steps() == [5]
    got, step, metrics = load_checkpoint_bundle(d)
    assert step == 5 and metrics["val_f1"] == 0.3
    want = new.params["vit"]["norm"]["scale"]
    assert torch.equal(got["params"]["vit"]["norm"]["scale"], want)
    assert mgr.save(7, old) and mgr.save(6, new)      # branch resume
    assert mgr.all_steps() == [5, 6, 7] and mgr.latest_step() == 7


def test_async_save_then_drain(tmp_path):
    st = _state(steps=1)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, st, metrics={"val_f1": 0.4})
    with torch.no_grad():
        st.leaves()[0].add_(1.0)        # the snapshot was taken at save()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1]
    got, step = load_params_from_dir(str(tmp_path))
    assert step == 1
    first = S.tree_flatten(got["params"])[0][0]
    assert torch.equal(first + 1.0, st.leaves()[0])
    mgr.save(2, st)
    assert mgr.latest_step() == 2      # reads drain the pending write
    mgr.close()


def test_load_checkpoint_bundle_and_list(tmp_path):
    st = _state(steps=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, st, metrics={"val_f1": 0.7, "epoch": 1})
    variables, step, metrics = load_checkpoint_bundle(str(tmp_path))
    assert step == 2 and metrics == {"val_f1": 0.7, "epoch": 1}
    for x, y in zip(S.tree_flatten(variables["params"])[0], st.leaves()):
        assert torch.equal(x, y)
    ema, _, _ = load_checkpoint_bundle(str(tmp_path), ema=True)
    for x, y in zip(S.tree_flatten(ema["params"])[0], st.opt_state["ema"]):
        assert torch.equal(x, y)
    assert list_checkpoints(str(tmp_path)) == [(2, metrics)]
    CheckpointManager(str(tmp_path / "plain")).save(
        1, _state(ema=None, steps=0))
    with pytest.raises(ValueError, match="ema_decay"):
        load_checkpoint_bundle(str(tmp_path / "plain"), ema=True)


def test_registry_loads_checkpoint_directories_and_ema(tmp_path):
    """build_model on a training run's save_dir: the last iterate, or the
    EMA shadow with ema=True (ViT-B geometry, the registry's entry)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        tm = TViT(img_size=32, dropout=0.0)
    st = S.create_train_state(tm, S.make_optimizer(1e-3, ema_decay=0.5),
                              seed=0, device="cpu")
    with torch.no_grad():
        for e in st.opt_state["ema"]:
            e.mul_(0.5)                           # a shadow unlike the iterate
    CheckpointManager(str(tmp_path)).save(3, st, metrics={"val_f1": 0.1})
    for ema, tree in ((False, st.params),
                      (True, S.tree_unflatten(st.paths, st.opt_state["ema"]))):
        m = treg.build_model("Custom_ViT_FineTuned",
                             checkpoint_path=str(tmp_path), ema=ema,
                             img_size=32, device="cpu")
        want = tconvert.antispoof_to_torch({"params": tree})
        for k, v in m.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def _sd(seed):
    variables = JViT(patch_size=16, dropout=0.0, **GEOM).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
    return variables, jconvert.antispoof_to_torch(variables)


def test_save_torch_checkpoint_crosses_both_ways(tmp_path):
    variables, sd = _sd(4)
    p1, p2 = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    tconvert.save_torch_checkpoint(p1, variables, epoch=3,
                                   metrics={"auc": 0.5}, config={"a": 1})
    jconvert.save_torch_checkpoint(p2, variables, epoch=3,
                                   metrics={"auc": 0.5}, config={"a": 1})
    for a, b in ((jconvert.load_torch_checkpoint(p1),
                  tconvert.load_torch_checkpoint(p2)),
                 (tconvert.load_torch_checkpoint(p1), sd)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    whole = torch.load(p1, weights_only=True)
    assert set(whole) == {"epoch", "model_state_dict", "metrics", "config"}
    assert whole["epoch"] == 3 and whole["metrics"] == {"auc": 0.5}


class _Evil:
    def __reduce__(self):
        return (print, ("unpickled",))


@pytest.mark.parametrize("metrics", [
    None, {"f1": np.float64(0.9), "n": np.int64(3)},
    {"roc": np.linspace(0, 1, 5), "t": np.float32(0.5)}],
    ids=["plain", "numpy_scalar", "numpy_array"])
def test_registry_reads_reference_pth_with_numpy_metrics(tmp_path, metrics):
    """The reference's save_checkpoint stores sklearn's numpy values in
    ``metrics``: the port loads them with weights_only=True (numpy's
    reconstructors allowed) to the same tensors as JAX's
    weights_only=False loader; any other class is still refused."""
    _, sd = _sd(5)
    path = str(tmp_path / "best_model.pth")
    obj = {"model_state_dict": {k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()}}
    if metrics is not None:
        obj.update(epoch=7, metrics=metrics, config={"lr": 3e-4})
    torch.save(obj, path)
    got = tconvert.load_torch_checkpoint(path)
    want = jconvert.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k])
    m = TViT(img_size=32, **GEOM)
    m.load_state_dict(tconvert.antispoof_from_checkpoint(got, depth=2))
    evil = str(tmp_path / "evil.pth")
    torch.save({"model_state_dict": {}, "metrics": {"x": _Evil()}}, evil)
    with pytest.raises(pickle.UnpicklingError):
        tconvert.load_torch_checkpoint(evil)


def test_registry_build_model_takes_a_numpy_metrics_pth(tmp_path):
    """The whole path: build_model on a ViT-B .pth with numpy metrics."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        sd = TViT(img_size=32).state_dict()
    path = str(tmp_path / "best_model_run.pth")
    torch.save({"epoch": 9, "model_state_dict": sd, "metrics": {
        "val_f1": np.float64(0.93), "cm": np.eye(2)}}, path)
    m = treg.build_model("Custom_ViT_FineTuned", checkpoint_path=path,
                         img_size=32, device="cpu")
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_jax_orbax_directory_reads_through_orbax(tmp_path):
    """A JAX Trainer's Orbax directory (params, EMA) reads into the
    port's layout where orbax imports."""
    from vit_spoof_detection_pda_tpu.train.state import (create_train_state,
                                                         make_optimizer)
    from vit_spoof_detection_pda_tpu.utils.checkpoint import (
        CheckpointManager as JManager)

    jstate = create_train_state(
        JViT(patch_size=16, dropout=0.0, **GEOM),
        make_optimizer(1e-3, ema_decay=0.5), jax.random.PRNGKey(0),
        input_shape=(1, 32, 32, 3))
    mgr = JManager(str(tmp_path))
    mgr.save(4, jstate, metrics={"val_f1": 0.25, "epoch": 0})
    mgr.close()
    variables, step, metrics = load_checkpoint_bundle(str(tmp_path))
    assert step == 4 and metrics["val_f1"] == 0.25
    want = jax.tree.leaves(jstate.params)
    got = S.tree_flatten(variables["params"])[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ema, _, _ = load_checkpoint_bundle(str(tmp_path), ema=True)
    assert len(S.tree_flatten(ema["params"])[0]) == len(want)
    assert list_checkpoints(str(tmp_path))[0][0] == 4
