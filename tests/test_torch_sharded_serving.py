"""Data-parallel scoring, fleet artifacts and mean pooling under a seq
axis (``models/fastserve.py::serving_forward_sharded``,
``eval/runner.py``, ``models/artifact.py``, ``models/vit.py``) across two
real processes: a gloo group of 2 ranks on the CPU running
tests/test_torch_sharded_serving_worker.py, which imports no JAX.  The
JAX side runs here, in the pytest process, on its 8 virtual CPU devices
(Pallas in interpret mode); inputs go to the workers and results come
back as ``.npz`` files in ``tmp_path``.

Models: the tiny serving geometry of tests/test_torch_linear_serving.py
(patch 16, D 64, depth 2, 2 heads, 32x32; the anti-spoof head with tanh
GELU and the linear head), and JAX's sequence-parallel test model (patch
8, D 64, depth 2, 4 heads, T 17, which no seq size divides) with mean
pooling.  Beside them, in this process: a JAX Orbax checkpoint of a
pipeline-parallel run (``parallel/pipeline.py``'s packed layout) read by
the port, bit-equal to the unpacked tree.

Tolerances:
- ``serving_forward_sharded`` against the unsharded port forward of the
  whole batch (this process's and each rank's own): bit-equal, f32 and
  bf16 (each row runs the same operations, only the batch is split);
- against JAX's ``serving_forward_sharded`` on a 2-device mesh: atol
  2e-4 / rtol 1e-4 at f32, 5e-3 at bf16 (tests/test_torch_fastserve.py's
  bounds);
- ``run_inference(fastserve=True, mesh=)``: bit-equal to the unsharded
  call, in record order;
- the fleet artifact against the module path: atol 1e-6 (f32; the ranks'
  frozen programs score 4 rows where the module scores 8), pred equal;
- mean pooling: the backbone's features within 1e-5 of JAX's mean-pooled
  ``ViT`` (f32), the logits within 1e-5 of the port's single-process
  forward, the gradients summed over the ranks within atol 1e-5 / rtol
  1e-4 of the single-process gradients.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import fastserve as jfast
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.parallel import mesh as jmesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_torch_sharded_serving_worker as W  # noqa: E402
from test_fastserve import _TinyLinearViT  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.data.manifest import Record  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.eval import runner as trunner  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models import artifact as A  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models.convert import load_jax_params  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models.vit import (  # noqa: E402
    ViTAntiSpoof, fold_normalization)
from vit_spoof_detection_pda_tpu_torch.parallel.dryrun import free_port  # noqa: E402

F32 = dict(atol=2e-4, rtol=1e-4)
BF16_SCORE_ATOL = 5e-3
HEADS = {"antispoof": tfast.serving_forward,
         "linear": tfast.serving_forward_linear}
JHEADS = {"antispoof": jfast.serving_forward,
          "linear": jfast.serving_forward_linear}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("serve")
    zeros = jnp.zeros((1, 32, 32, 3))
    as_params = jvit.ViTAntiSpoof(**W.GEOM, hidden=16, gelu="tanh").init(
        jax.random.PRNGKey(0), zeros)["params"]
    lin_params = _TinyLinearViT().init(jax.random.PRNGKey(3),
                                       zeros)["params"]
    sp_params = jvit.ViTAntiSpoof(**W.SP_GEOM).init(
        jax.random.PRNGKey(1), zeros)["params"]
    for name, tree in (("as", as_params), ("lin", lin_params),
                       ("sp", sp_params)):
        np.savez(d / f"{name}_params.npz", **_flat(tree))
    u8 = np.random.default_rng(5).integers(0, 256, (8, 32, 32, 3),
                                           dtype=np.uint8)
    x_sp = np.random.default_rng(6).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    rec_y = np.random.default_rng(7).integers(0, 2, 10)
    faces = np.random.default_rng(8).integers(0, 256, (10, 32, 32, 3),
                                              dtype=np.uint8)
    for i in range(10):
        Image.fromarray(faces[i]).save(d / f"face{i}.png")
    np.savez(d / "data.npz", u8=u8, x_sp=x_sp, rec_y=rec_y)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable,
         os.path.join(HERE, "test_torch_sharded_serving_worker.py"),
         str(r), "2", str(port), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, _) in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    res = [dict(np.load(d / f"serve_rank{r}.npz")) for r in range(2)]
    return {"dir": d, "as": as_params, "lin": lin_params, "sp": sp_params,
            "u8": u8, "x_sp": x_sp, "rec_y": rec_y, "res": res}


def _params(runs, head):
    return runs["as"] if head == "antispoof" else runs["lin"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("head", ["antispoof", "linear"])
def test_sharded_forward_is_bit_equal_to_the_unsharded(runs, head, dt):
    res = runs["res"]
    folded = fold_normalization({"params": _params(runs, head)})["params"]
    want = HEADS[head](folded, runs["u8"], num_heads=2, depth=2,
                       dtype=W.DTYPES[dt], device="cpu").numpy()
    for r in range(2):
        np.testing.assert_array_equal(res[r][f"sharded/{head}/{dt}"], want)
        np.testing.assert_array_equal(res[r][f"single/{head}/{dt}"], want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("head", ["antispoof", "linear"])
def test_sharded_forward_matches_jax_sharded(runs, head, dt):
    folded = jvit.fold_normalization({"params": _params(runs, head)})
    mesh = jmesh.make_mesh(data=2, model=1, devices=jax.devices()[:2])
    want = np.asarray(jfast.serving_forward_sharded(
        folded["params"], jnp.asarray(runs["u8"]), mesh, fn=JHEADS[head],
        num_heads=2, depth=2,
        dtype=jnp.float32 if dt == "f32" else jnp.bfloat16,
        interpret=True), np.float32)
    got = runs["res"][0][f"sharded/{head}/{dt}"]
    assert got.shape == want.shape
    tol = F32 if dt == "f32" else dict(atol=BF16_SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, **tol)


def test_a_batch_off_the_data_axis_raises_jax_error(runs):
    folded = jvit.fold_normalization({"params": runs["as"]})
    mesh = jmesh.make_mesh(data=2, model=1, devices=jax.devices()[:2])
    with pytest.raises(ValueError) as e:
        jfast.serving_forward_sharded(
            folded["params"], jnp.asarray(runs["u8"][:7]), mesh,
            num_heads=2, depth=2, interpret=True)
    for r in range(2):
        assert str(runs["res"][r]["odd_batch_error"]) == str(e.value)


@pytest.mark.parametrize("head", ["antispoof", "linear"])
def test_run_inference_fastserve_over_a_mesh_in_record_order(runs, head):
    d = runs["dir"]
    recs = [Record(path=str(d / f"face{i}.png"), label=int(y))
            for i, y in enumerate(runs["rec_y"])]
    m = (W.antispoof(runs["as"], torch.bfloat16) if head == "antispoof"
         else W.linear_head(runs["lin"]))
    want = trunner.run_inference(m, recs, batch_size=4, img_size=32,
                                 num_workers=1, fastserve=True)
    for r in range(2):
        got = runs["res"][r]
        for k in ("labels", "prob1", "pred"):
            np.testing.assert_array_equal(got[f"infer/{head}/{k}"], want[k])


def test_fleet_artifact_round_trips_on_two_ranks(runs):
    m = W.antispoof(runs["as"])
    want = trunner.make_infer_fn(m)(torch.from_numpy(runs["u8"]))
    for r in range(2):
        got = runs["res"][r]
        assert got["fleet/mesh_shape"].tolist() == [2, 1]
        for key in ("fleet/prob1", "fleet_mesh/prob1"):
            np.testing.assert_allclose(got[key], want["prob1"].numpy(),
                                       atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["fleet/pred"],
                                      want["pred"].numpy())
        assert "single-device" in str(got["single_with_mesh_error"])


def test_fleet_artifact_refusals_follow_jax(runs, tmp_path):
    """tests/test_artifact.py::test_fleet_artifact_validation's cases,
    and a fleet artifact loaded where no process group of its size is."""
    from types import SimpleNamespace

    m = W.antispoof(runs["as"])
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           mesh=torch.zeros(2, 1))
    with pytest.raises(ValueError, match="not divisible"):
        A.export_serving(m, mode="module", batch_size=5, img_size=32,
                         mesh=mesh)
    with pytest.raises(ValueError, match="module-mode only"):
        A.export_serving(m, mode="fastserve", batch_size=8, mesh=mesh)
    with pytest.raises(ValueError, match="concrete batch_size"):
        A.export_serving(m, mode="module", batch_size=None, mesh=mesh)
    tp = SimpleNamespace(mesh_dim_names=("data", "model"),
                         mesh=torch.zeros(1, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9b"):
        A.export_serving(m, mode="module", batch_size=8, mesh=tp)
    with pytest.raises(ValueError, match="exported for 2 devices; 1 "
                       "visible"):
        A.load_serving_artifact(runs["dir"] / "fleet", device="cpu")
    small = SimpleNamespace(mesh_dim_names=("data", "model"),
                            mesh=torch.zeros(4, 1))
    with pytest.raises(ValueError, match="needs 2 devices"):
        A.load_serving_artifact(runs["dir"] / "fleet", small, device="cpu")


def test_mean_pool_under_a_seq_mesh_matches_jax(runs):
    x = runs["x_sp"]
    jfeats = np.asarray(jvit.ViT(
        patch_size=8, embed_dim=64, depth=2, num_heads=4,
        pool="mean").apply({"params": runs["sp"]["vit"]}, jnp.asarray(x)))
    single = load_jax_params(ViTAntiSpoof(**W.SP_GEOM, img_size=32,
                                          pool="mean", dropout=0.0),
                             {"params": runs["sp"]}).eval()
    with torch.no_grad():
        want_logits = single(torch.from_numpy(x)).numpy()
    for r in range(2):
        got = runs["res"][r]
        assert int(got["mean/cp_calls"]) == W.SP_GEOM["depth"]
        np.testing.assert_allclose(got["mean/feats"], jfeats, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["mean/logits"], want_logits,
                                   atol=1e-5, rtol=0)


def test_mean_pool_gradients_under_a_seq_mesh_sum_to_single(runs):
    single = load_jax_params(ViTAntiSpoof(**W.SP_GEOM, img_size=32,
                                          pool="mean", dropout=0.0),
                             {"params": runs["sp"]}).eval()
    (single(torch.from_numpy(runs["x_sp"])).float() ** 2).sum().backward()
    for r in range(2):
        got = runs["res"][r]
        for k, p in single.named_parameters():
            np.testing.assert_allclose(got[f"mean/grad/{k}"],
                                       p.grad.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)


def test_pipeline_packed_jax_checkpoint_reads_unpacked(tmp_path):
    """A JAX Orbax checkpoint of a pipeline-parallel run (its params and
    EMA shadow in ``pack_pipeline_params``' stacked layout, as the JAX
    Trainer's ``param_layout`` makes them) reads into the port's
    per-layer tree, bit-equal to JAX's ``unpack_pipeline_params``; the
    port's pack / unpack mirror JAX's leaf for leaf."""
    from vit_spoof_detection_pda_tpu.parallel import pipeline as jpipe
    from vit_spoof_detection_pda_tpu.train.state import (
        create_train_state, find_ema_params, make_optimizer)
    from vit_spoof_detection_pda_tpu.utils.checkpoint import (
        CheckpointManager as JManager)
    from vit_spoof_detection_pda_tpu_torch.parallel import pipeline as tpipe
    from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (
        load_checkpoint_bundle)

    depth = 2
    jm = jvit.ViTAntiSpoof(**W.GEOM, hidden=16, dropout=0.0)
    state = create_train_state(
        jm, make_optimizer(1e-3, ema_decay=0.5), jax.random.PRNGKey(0),
        input_shape=(1, 32, 32, 3),
        param_layout=lambda p: jpipe.pack_pipeline_params(
            {"params": p}, depth)["params"])
    assert "blocks" in state.params["vit"]
    mgr = JManager(str(tmp_path))
    mgr.save(3, state, metrics={"val_f1": 0.5, "epoch": 0})
    mgr.close()
    want = jpipe.unpack_pipeline_params({"params": state.params})["params"]
    for ema in (False, True):
        variables, step, _ = load_checkpoint_bundle(str(tmp_path), ema=ema)
        assert step == 3 and "blocks" not in variables["params"]["vit"]
        ref = (jpipe.unpack_pipeline_params(
            {"params": find_ema_params(state.opt_state)})["params"]
            if ema else want)
        got, exp = _flat(variables["params"]), _flat(ref)
        assert sorted(got) == sorted(exp)
        for k in exp:
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    np_tree = jax.tree.map(np.asarray, {"params": want})
    packed = tpipe.pack_pipeline_params(np_tree, depth)
    jpacked = jpipe.pack_pipeline_params({"params": want}, depth)
    assert _flat(packed["params"]).keys() == _flat(jpacked["params"]).keys()
    for k, v in _flat(jpacked["params"]).items():
        np.testing.assert_array_equal(_flat(packed["params"])[k], v)
    round_trip = tpipe.unpack_pipeline_params(packed)
    for k, v in _flat(np_tree["params"]).items():
        np.testing.assert_array_equal(_flat(round_trip["params"])[k], v)
    assert tpipe.unpack_pipeline_params(np_tree) is np_tree
    with pytest.raises(ValueError, match="depth=3"):
        tpipe.stack_block_params(np_tree["params"]["vit"], 3)
