"""The port's parallel layer (``parallel/mesh.py``) in one process: the
mesh shapes and error cases against the JAX package's (its 8 virtual CPU
devices; tests/test_parallel.py, tests/test_sequence_parallel.py,
tests/test_sharding_config.py), the Megatron and FSDP rule tables leaf by
leaf against JAX's on the same parameter tree, the Trainer's sharding
rules, the record and batch sharding, and the branches that ROADMAP
Queue 1 item 9b still owns, each raising and naming it (and mean pooling
under a seq axis, which landed from it).

A ``DeviceMesh`` needs a process group: the fixture ``world8`` joins an
8-rank ``fake`` group (``FakeStore``: one process, no communication) and
leaves it after the test; the multi-rank runs are in
tests/test_torch_sequence_parallel.py.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.config import Config as JConfig
from vit_spoof_detection_pda_tpu.data import loader as jloader
from vit_spoof_detection_pda_tpu.data.manifest import Record as JRecord
from vit_spoof_detection_pda_tpu.models.vit import ViTAntiSpoof as JViT
from vit_spoof_detection_pda_tpu.parallel import mesh as jmesh
from vit_spoof_detection_pda_tpu_torch.config import Config
from vit_spoof_detection_pda_tpu_torch.data import loader as tloader
from vit_spoof_detection_pda_tpu_torch.data.manifest import Record
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof as TViT
from vit_spoof_detection_pda_tpu_torch.ops import attention as att
from vit_spoof_detection_pda_tpu_torch.parallel import mesh as pm
from vit_spoof_detection_pda_tpu_torch.train import trainer as ttrainer

LAYOUTS = [(-1, 1), (-1, 2), (4, 2), (2, 4), (8, 1), (1, 8), (-1, 3),
           (3, 2), (2, 2), (-1, 8), (16, 1)]


@pytest.fixture
def world8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_shape(fn, *args):
    try:
        return tuple(fn(*args).devices.shape)
    except ValueError as e:
        return ("ValueError", str(e))


def _port_shape(fn, *args):
    try:
        return tuple(fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("first,second", LAYOUTS)
def test_mesh_shapes_and_errors_match_jax(first, second):
    """(data, model) and (data, seq) layouts over 8 ranks: the same shape
    or the same ValueError as JAX's make_mesh / make_seq_mesh."""
    assert _port_shape(pm.mesh_shape, first, second, 8, "model") == \
        _jax_shape(jmesh.make_mesh, first, second)
    assert _port_shape(pm.mesh_shape, first, second, 8, "seq") == \
        _jax_shape(lambda d, s: jmesh.make_seq_mesh(s, d), first, second)


def test_make_mesh_and_seq_mesh_build_device_meshes(world8):
    m = pm.make_mesh(device_type="cpu")
    assert pm.axis_sizes(m) == {"data": 8, "model": 1}
    m = pm.make_mesh(data=4, model=2, device_type="cpu")
    assert m.mesh_dim_names == ("data", "model") and m.mesh.shape == (4, 2)
    m = pm.make_seq_mesh(seq=4, data=2, device_type="cpu")
    assert m.mesh_dim_names == ("data", "seq") and m.mesh.shape == (2, 4)
    assert pm.axis_rank(m, "seq") == 0 and pm.axis_rank(m, "model") == 0
    with pytest.raises(ValueError):
        pm.make_seq_mesh(seq=3, data=2, device_type="cpu")
    with pytest.raises(ValueError):
        pm.make_mesh(data=3, model=2, device_type="cpu")


def _shardings(overrides, cfg_cls):
    return cfg_cls().with_overrides(
        {f"sharding.{k}": v for k, v in overrides.items()}).sharding


@pytest.mark.parametrize("overrides", [
    {}, {"model_parallel": 2}, {"data_parallel": 2, "model_parallel": 4},
    {"seq_parallel": 4}, {"seq_parallel": 2, "data_parallel": 4},
    {"data_parallel": 8}, {"fsdp": True}])
def test_mesh_from_config_matches_jax(world8, overrides):
    want = jmesh.mesh_from_config(_shardings(overrides, JConfig))
    got = pm.mesh_from_config(_shardings(overrides, Config),
                              device_type="cpu")
    assert got.mesh_dim_names == tuple(want.axis_names)
    assert tuple(got.mesh.shape) == tuple(want.devices.shape)
    # the layout the doctor reports is the mesh's
    assert pm.config_layout(_shardings(overrides, Config), 8) == dict(
        zip(want.axis_names, want.devices.shape))


@pytest.mark.parametrize("overrides,match", [
    ({"model_parallel": 2, "seq_parallel": 2}, "mutually exclusive"),
    ({"data_parallel": 3, "model_parallel": 2}, "3x2"),
    ({"seq_parallel": 3}, "not divisible"),
    ({"model_parallel": 2, "fsdp": True}, "fsdp"),
    ({"seq_parallel": 2, "fsdp": True}, "fsdp"),
    ({"seq_parallel": 2, "pipeline_parallel": 2}, "exclusive"),
    ({"pipeline_parallel": 2, "fsdp": True}, "fsdp")])
def test_mesh_from_config_rejects_what_jax_rejects(world8, overrides, match):
    with pytest.raises(ValueError, match=match):
        jmesh.mesh_from_config(_shardings(overrides, JConfig))
    with pytest.raises(ValueError, match=match):
        pm.mesh_from_config(_shardings(overrides, Config), device_type="cpu")


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_multi_host"):
        pm.make_mesh(device_type="cpu")


def _jax_tree():
    module = JViT(patch_size=8, embed_dim=64, depth=2, num_heads=2,
                  hidden=32)
    return module.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3)))["params"]


def _torch_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _pairs(port, jax_specs, path=()):
    if isinstance(port, dict):
        for k in port:
            yield from _pairs(port[k], jax_specs[k], path + (k,))
    else:
        yield path, port, tuple(jax_specs)


def test_param_specs_match_jax_leaf_by_leaf():
    tree = _jax_tree()
    pairs = list(_pairs(pm.param_specs(_torch_tree(tree)),
                        jmesh.param_specs(tree)))
    assert len(pairs) == len(jax.tree.leaves(tree))
    for path, got, want in pairs:
        assert got == want, path
    specs = pm.param_specs(_torch_tree(tree))
    assert specs["vit"]["block0"]["attn"]["qkv"]["kernel"] == (None, "model")
    assert specs["vit"]["block0"]["mlp"]["fc2"]["kernel"] == ("model", None)
    # a stacked [L, D, 3D] kernel anchors the rule to its trailing dims
    stacked = {"vit": {"blocks": {"attn": {"qkv": {
        "kernel": torch.zeros(2, 64, 192)}}}}}
    assert pm.param_specs(stacked)["vit"]["blocks"]["attn"]["qkv"][
        "kernel"] == (None, None, "model")


@pytest.mark.parametrize("n_data,min_size", [(8, 2 ** 16), (2, 1024),
                                             (3, 256), (4, 1)])
def test_fsdp_param_specs_match_jax_leaf_by_leaf(n_data, min_size):
    tree = _jax_tree()
    pairs = list(_pairs(pm.fsdp_param_specs(_torch_tree(tree), n_data,
                                            min_size),
                        jmesh.fsdp_param_specs(tree, n_data, min_size)))
    assert len(pairs) == len(jax.tree.leaves(tree))
    for path, got, want in pairs:
        assert got == want, path
    assert pm.batch_spec() == tuple(jmesh.batch_spec())


def _cfg(**sharding):
    return Config().with_overrides(
        {f"sharding.{k}": v for k, v in sharding.items()})


@pytest.mark.parametrize("sharding,exc,match", [
    ({"model_parallel": 2}, NotImplementedError, "item 9b"),
    ({"fsdp": True}, NotImplementedError, "item 9b"),
    ({"pipeline_parallel": 2}, NotImplementedError, "item 9b"),
    ({"model_parallel": 2, "seq_parallel": 2}, ValueError, "exclusive"),
    ({"seq_parallel": 2, "fsdp": True}, ValueError, "fsdp"),
    ({"seq_parallel": 2}, ValueError, "1 devices not divisible by seq=2"),
    ({"data_parallel": 2}, ValueError, "2x1 != 1 devices")])
def test_trainer_sharding_rules(sharding, exc, match):
    """On one rank: data and sequence layouts that need more ranks fail on
    the rank count, tensor parallelism, FSDP and the pipeline name item
    9b, and the JAX exclusivity errors hold."""
    with pytest.raises(exc, match=match):
        ttrainer.check_sharding(_cfg(**sharding))


def test_trainer_sharding_rules_pass_and_build_no_mesh_on_one_rank():
    for sharding in ({}, {"data_parallel": 1}, {"seq_parallel": 1}):
        assert ttrainer.resolve_mesh(_cfg(**sharding), device="cpu") is None


def test_trainer_refuses_a_model_axis(world8):
    mesh = pm.make_mesh(data=4, model=2, device_type="cpu")
    with pytest.raises(NotImplementedError, match="item 9b"):
        ttrainer.check_sharding(_cfg(), mesh)
    module = TViT(embed_dim=64, depth=1, num_heads=2, hidden=16, img_size=32)
    with pytest.raises(NotImplementedError, match="item 9b"):
        ttrainer.Trainer(_cfg(**{"data_parallel": 4, "model_parallel": 2}),
                         module, train_batches=lambda e, skip=0: iter(()),
                         val_batches=lambda: iter(()), steps_per_epoch=1,
                         device="cpu")


def test_item_9b_branches_raise_and_name_it(world8):
    tp = pm.make_mesh(data=4, model=2, device_type="cpu")
    qkv = torch.zeros(2, 17, 3 * 64)
    with pytest.raises(NotImplementedError, match="item 9b"):
        att.dispatch_attention_qkv(qkv, 4, mesh=tp)
    with pytest.raises(NotImplementedError, match="item 9b"):
        with att.attention_sharding(tp):
            att.dispatch_attention_qkv(qkv, 4)
    with pytest.raises(NotImplementedError, match="item 9b"):
        pm.shard_params_fsdp({}, tp)
    with pytest.raises(NotImplementedError, match="item 9b"):
        pm.shard_params({"w": torch.zeros(2)}, tp)
    from vit_spoof_detection_pda_tpu_torch.eval.runner import run_inference
    with pytest.raises(NotImplementedError, match="item 9b"):
        run_inference(torch.nn.Linear(2, 2), [], fastserve=True, mesh=tp)
    # mean pooling under a seq axis landed (its two-rank parity is in
    # tests/test_torch_sharded_serving.py); on this one-process fake group
    # it runs its sequence-parallel path, one dispatch a layer
    sp = pm.make_seq_mesh(seq=2, data=4, device_type="cpu")
    mean_pool = TViT(embed_dim=64, depth=1, num_heads=2, hidden=16,
                     img_size=32, patch_size=8, pool="mean").eval()
    calls = att._context["cp_calls"]
    with torch.no_grad(), att.attention_sharding(sp):
        logits = mean_pool(torch.zeros(2, 32, 32, 3))
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()
    assert att._context["cp_calls"] == calls + 1
    capture = TViT(embed_dim=64, depth=1, num_heads=2, hidden=16,
                   img_size=32, patch_size=8, capture_attention=True)
    with pytest.raises(ValueError, match="capture_attention"):
        with att.attention_sharding(sp):
            capture(torch.zeros(2, 32, 32, 3))


def test_sequence_parallel_dispatch_needs_the_token_count(world8):
    sp = pm.make_seq_mesh(seq=2, data=4, device_type="cpu")
    with pytest.raises(ValueError, match="valid_len"):
        att.dispatch_attention_qkv(torch.zeros(2, 8, 192), 4, mesh=sp)


def test_shard_for_host_matches_jax(monkeypatch):
    """Equal disjoint shares by rank, the same records as JAX's slice by
    process; one rank keeps everything."""
    recs = [Record(path=f"p{i}", label=i % 2) for i in range(999)]
    jrecs = [JRecord(path=f"p{i}", label=i % 2) for i in range(999)]
    assert tloader.shard_for_host(recs) == recs
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(pm, "world_size", lambda: 4)
    shares = []
    for idx in range(4):
        monkeypatch.setattr(jax, "process_index", lambda i=idx: i)
        monkeypatch.setattr(pm, "rank", lambda i=idx: i)
        share = tloader.shard_for_host(recs)
        assert ([r.path for r in share]
                == [r.path for r in jloader.shard_for_host(jrecs)])
        shares.append({r.path for r in share})
    assert all(len(s) == 249 for s in shares)
    assert len(set().union(*shares)) == 4 * 249
    with pytest.raises(ValueError, match="smaller"):
        tloader.shard_for_host(recs[:3])


def test_shard_for_host_and_batch_follow_the_data_axis(world8, monkeypatch):
    """Under a (data 4, seq 2) mesh the ranks of one sequence group share
    their records and rows: the shares follow the data coordinate."""
    mesh = pm.make_seq_mesh(seq=2, data=4, device_type="cpu")
    monkeypatch.setattr(mesh, "get_local_rank", lambda axis: 3)
    recs = [Record(path=f"p{i}", label=0) for i in range(10)]
    assert [r.path for r in tloader.shard_for_host(recs, mesh)] == \
        ["p3", "p7"]
    batch = {"image": np.arange(16).reshape(8, 2), "label": np.arange(8)}
    rows = pm.shard_batch(batch, mesh)
    assert rows["label"].tolist() == [6, 7]
    with pytest.raises(ValueError, match="does not divide"):
        pm.shard_batch({"label": np.arange(6)}, mesh)


def test_fleet_artifacts_and_packed_checkpoints_name_item_9b(tmp_path):
    """Both landed from ROADMAP Queue 1 item 9b: a fleet artifact over a
    model axis still names it; a JAX checkpoint in the pipeline's packed
    layout reads into the per-layer tree (bit for bit; the EMA shadow's
    case is in tests/test_torch_sharded_serving.py)."""
    from vit_spoof_detection_pda_tpu.parallel.pipeline import (
        pack_pipeline_params, unpack_pipeline_params)
    from vit_spoof_detection_pda_tpu.train.state import (
        create_train_state as j_create, make_optimizer as j_opt)
    from vit_spoof_detection_pda_tpu.utils.checkpoint import (
        CheckpointManager as JManager)
    from vit_spoof_detection_pda_tpu_torch.models import artifact as A
    from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (
        load_checkpoint_bundle)

    from types import SimpleNamespace

    module = TViT(embed_dim=64, depth=2, num_heads=2, hidden=16, img_size=32)
    tp = SimpleNamespace(mesh_dim_names=("data", "model"),
                         mesh=torch.zeros(4, 2))
    with pytest.raises(NotImplementedError, match="item 9b"):
        A.export_serving(module, mode="module", batch_size=8, mesh=tp)
    jm = JViT(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)
    jstate = j_create(jm, j_opt(1e-3), jax.random.PRNGKey(0),
                      input_shape=(1, 32, 32, 3))
    jstate = jstate.replace(params=pack_pipeline_params(
        {"params": jstate.params}, 2)["params"])
    mgr = JManager(str(tmp_path / "packed"))
    mgr.save(1, jstate, metrics={"val_f1": 0.5})
    mgr.close()
    variables, step, _ = load_checkpoint_bundle(str(tmp_path / "packed"))
    want = unpack_pipeline_params({"params": jstate.params})["params"]
    assert step == 1 and "blocks" not in variables["params"]["vit"]
    got_leaves = jax.tree.leaves(jax.tree.map(np.asarray,
                                              variables["params"]))
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The dry run's entry point and function default to the card: with
    none they stop before any rank is spawned."""
    from vit_spoof_detection_pda_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "run_ranks", lambda *a, **k: pytest.fail(
        "spawned ranks without a card"))
    with pytest.raises(SystemExit, match="--device cpu"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)


def test_dryrun_two_ranks_on_the_cpu(capsys):
    """One (data 1 x seq 2) step on two spawned gloo ranks through
    ``run_ranks``: an equal finite loss on both, the CP path taken."""
    from vit_spoof_detection_pda_tpu_torch.parallel import dryrun

    assert dryrun.main(["2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "data 1 x seq 2 on cpu" in out
    assert "sequence-parallel dispatches 2 a step" in out
