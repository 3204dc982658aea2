"""The port's GPipe schedule (``parallel/pipeline.py``) across real
processes, held against the JAX package (tests/test_pipeline.py:48-355):
gloo groups of 2 and 4 ranks on the CPU, one process per rank running
tests/torch_mp_worker.py, which imports no JAX; the JAX side runs here
on its virtual CPU devices.  The model and inputs are
tests/torch_mp_common.py's (JAX's pipeline test model, depth 4).

- Forward at (data, pipe, model, microbatches) = (1, 2, 1, 2), (1, 2, 1,
  4), (2, 2, 1, 4), (1, 4, 1, 4), (2, 2, 1, 2), and DP x TP x PP (1, 2,
  2, 2), (1, 2, 2, 4): every stage returns the same logits, the data
  groups' rows assemble into JAX's ``pipeline_apply`` on the same mesh
  and its one-device forward within atol 1e-5 / rtol 1e-5; under a model
  axis the attention ran on the rank's heads once a layer a microbatch.
- Gradients of the mean CE with and without remat against JAX's
  ``jax.grad`` (atol 2e-5 / rtol 2e-4), remat against no remat within
  1e-6; one focal-loss SGD step against JAX's (atol 2e-5 / rtol 2e-4),
  with dropout 0.1 against the port's one-process step; TP x PP's
  gradients and step alike, and 3 heads over its model axis.
- The stages hold depth / pipe layers of the packed tree; the packed
  specs and JAX's ``ValueError``s, on an 8-rank fake group.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from vit_spoof_detection_pda_tpu.parallel import pipeline as jpp

import torch_mp_common as C

W = C.W
CASES = [(2, 1, 2, 1, 2), (2, 1, 2, 1, 4), (4, 2, 2, 1, 4), (4, 1, 4, 1, 4),
         (4, 2, 2, 1, 2), (4, 1, 2, 2, 2), (4, 1, 2, 2, 4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    inputs = C.write_inputs(d)
    return {**inputs, "res": C.launch(d, "pp")}


def _jax_pp_forward(params, x, data, pipe, model, micro, geom=C.JGEOM):
    jm = C.JViT(dropout=0.0, **geom)
    mesh = jpp.make_pipe_mesh(pipe, data=data, model=model,
                              devices=jax.devices()[:data * pipe * model])
    return np.asarray(jax.jit(lambda v, im: jpp.pipeline_apply(
        jm, v, im, mesh, microbatches=micro))({"params": params}, x))


@pytest.mark.parametrize("world,data,pipe,model,micro", CASES)
def test_pp_forward_matches_jax(runs, world, data, pipe, model, micro):
    outs = C.ranks(runs["res"], world)
    key = f"{data}x{pipe}x{model}m{micro}"
    got = C.assembled(outs, f"fwd_{key}", data)
    want_calls = (C.JGEOM["depth"] // pipe) * micro if model > 1 else 0
    assert all(int(o[f"calls_{key}"]) == want_calls for o in outs)
    for want in (_jax_pp_forward(runs["params"], runs["x"], data, pipe,
                                 model, micro),
                 C.jax_forward(runs["params"], runs["x"])):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_gradients_match_jax_with_and_without_remat(runs, world):
    outs = C.ranks(runs["res"], world)
    want = C.jax_ce_grads(runs["params"], runs["x"], runs["y"])
    plain = C.unpacked(C.agreed(outs, "grad_remat0"))
    remat = C.unpacked(C.agreed(outs, "grad_remat1"))
    assert set(plain) == set(want) == set(remat)
    for path in sorted(want):
        np.testing.assert_allclose(plain[path], want[path], atol=2e-5,
                                   rtol=2e-4, err_msg=path)
        np.testing.assert_allclose(remat[path], plain[path], atol=1e-6,
                                   err_msg=path)


def _step_params(got):
    return C.unpacked({k[2:]: v for k, v in got.items()
                       if k.startswith("p/")})


@pytest.mark.parametrize("world,prefix", [(2, "step"), (4, "step"),
                                          (4, "tpp_step")])
def test_pp_step_matches_jax(runs, world, prefix):
    got = C.agreed(C.ranks(runs["res"], world), prefix)
    loss, gnorm, want = C.jax_step(runs["params"], runs["x"], runs["y"])
    assert float(got["loss"]) == pytest.approx(loss, abs=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), gnorm, rtol=1e-4)
    C.assert_params_close(_step_params(got), want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_step_replays_the_single_process_dropout(runs, world):
    got = C.agreed(C.ranks(runs["res"], world), "drop")
    loss, single = C.port_single_step(runs["params"], runs["x"], runs["y"],
                                      0.1)
    assert float(got["loss"]) == pytest.approx(loss, abs=1e-5)
    C.assert_params_close(_step_params(got), single, atol=2e-5, rtol=2e-4)


def test_tp_pp_gradients_and_heads(runs):
    outs = C.ranks(runs["res"], 4)
    got = C.unpacked(C.agreed(outs, "tpp_grad"))
    want = C.jax_ce_grads(runs["params"], runs["x"], runs["y"])
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], atol=2e-5,
                                   rtol=2e-4, err_msg=path)
    # two forwards (the gradient's and the step's): 2 layers x 2
    # microbatches each, per rank
    assert all(int(o["tpp_calls"]) == 8 for o in outs)
    got3 = C.assembled(outs, "fwd3_tpp", 1)
    np.testing.assert_allclose(
        got3, C.jax_forward(runs["params3"], runs["x"], C.JGEOM3),
        atol=1e-5, rtol=1e-5)


def test_stages_hold_their_layers(runs):
    """Each stage holds depth / pipe layers of every stacked leaf (and
    under TP x PP its Megatron slice of the trailing dims); the rest of
    the tree is whole on every stage."""
    for o in C.ranks(runs["res"], 2):
        assert tuple(o["shape/vit/blocks/attn/qkv/kernel"]) == (2, 64, 192)
        assert tuple(o["shape/vit/blocks/norm1/scale"]) == (2, 64)
        assert tuple(o["shape/vit/pos_embed"]) == (1, 5, 64)
        assert not any(k.startswith("shape/vit/block0") for k in o)
    for o in C.ranks(runs["res"], 4):
        assert tuple(o["tpp_shape/shape/vit/blocks/attn/qkv/kernel"]) == (
            2, 64, 96)
        assert tuple(o["tpp_shape/shape/vit/blocks/mlp/fc2/kernel"]) == (
            2, 128, 64)
        assert tuple(o["tpp_shape/shape/vit/blocks/attn/proj/bias"]) == (
            2, 64)


def _spec_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, (tuple,
                                               jax.sharding.PartitionSpec)))]


@pytest.mark.parametrize("tp", [False, True])
def test_packed_specs_match_jax_leaf_by_leaf(runs, tp):
    from vit_spoof_detection_pda_tpu_torch.parallel import pipeline as tpp
    variables = {"params": runs["params"]}
    stacked, _ = jpp.stack_block_params(runs["params"]["vit"], 4)
    want = _spec_leaves(jpp.stacked_pipe_specs(stacked, tp=tp))
    tstacked, _ = tpp.stack_block_params(
        jax.tree.map(np.asarray, dict(runs["params"]["vit"])), 4)
    got = _spec_leaves(tpp.stacked_pipe_specs(tstacked, tp=tp))
    assert got == want
    want = _spec_leaves(jpp.pipe_param_specs(variables, 4, tp=tp))
    got = _spec_leaves(tpp.pipe_param_specs(
        jax.tree.map(np.asarray, variables), 4, tp=tp))
    assert got == want


@pytest.fixture
def world8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_validation_errors(runs, world8):
    """JAX's messages (tests/test_pipeline.py:138), raised before any
    collective.  The port's ``images`` are a data rank's rows: 4 of the
    global 8 at data 2."""
    from vit_spoof_detection_pda_tpu_torch.parallel import mesh as pm
    from vit_spoof_detection_pda_tpu_torch.parallel import pipeline as tpp
    m = W.module(runs["params"])
    tree = W.torch_tree(runs["params"])
    x = torch.from_numpy(runs["x"][:4])
    mesh = pm.make_pipe_mesh(4, data=2, device_type="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        tpp.pipeline_apply(m, {"params": tree}, x, mesh, microbatches=3)
    with pytest.raises(ValueError, match="divisible by\\s+data"):
        tpp.pipeline_apply(m, {"params": tree}, x, mesh, microbatches=8)
    mesh8 = pm.make_pipe_mesh(8, data=1, device_type="cpu")
    with pytest.raises(ValueError, match="divisible by pipe"):
        tpp.pipeline_apply(m, {"params": tree}, torch.from_numpy(runs["x"]),
                           mesh8, microbatches=4)
    # a stage's slices of a depth-4 packed tree under a deeper module
    packed = tpp.pack_pipeline_params({"params": tree}, 4)["params"]
    layout = tpp.pipe_layout(packed, mesh)
    leaves, paths = pm.tree_flatten(packed)
    local = pm.tree_unflatten(paths, [layout.shard(w, i)
                                  for i, w in enumerate(leaves)])
    deeper = W.ViTAntiSpoof(dropout=0.0, **dict(W.GEOM, depth=8))
    with pytest.raises(ValueError, match="packed tree has 4"):
        tpp.pipeline_apply(deeper, {"params": local}, x, mesh,
                           microbatches=4)
