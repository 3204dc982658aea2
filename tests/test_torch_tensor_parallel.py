"""The port's Megatron tensor parallelism and FSDP across real processes,
held against the JAX package (tests/test_parallel.py:49-274): gloo
groups of 2 and 4 ranks on the CPU, one process per rank running
tests/torch_mp_worker.py, which imports no JAX; the JAX side runs here
on its virtual CPU devices.  The model and inputs are
tests/torch_mp_common.py's.

- Forward at (data, model) = (1, 2), (2, 2), (1, 4): the ranks of a data
  group agree bit for bit, the data groups' rows assemble into JAX's
  forward on a (data, model) mesh and its one-device forward, f32 within
  atol 2e-5 / rtol 1e-5 (JAX's tolerance); the attention ran on the
  rank's heads once a layer (kernel 8's plain version here).
- Heads the model axis does not divide (3 heads over 2 and 4 ranks): the
  attention is kept whole, JAX's dense result.
- The gradient of the mean CE (JAX ``jax.grad``, one device: atol 2e-5 /
  rtol 2e-4, tests/test_pipeline.py's) and one focal-loss SGD step
  (JAX's ``make_train_step``, lr 0.1, as tests/test_parallel.py:80:
  loss within 1e-5, leaves atol 5e-5 / rtol 1e-4); with dropout 0.1 the
  step equals the port's one-process step (the same masks on every model
  rank).  AdamW's sliced moments run in
  tests/test_torch_sharding_trainer.py's fits.
- The layouts hold each rank's slices (qkv's and fc1's columns, proj's
  and fc2's rows; FSDP the largest divisible axis of leaves of at least
  1,024 elements), the Adam moments alike, and FSDP's step equals JAX's.
"""

import numpy as np
import pytest

import jax

from vit_spoof_detection_pda_tpu.parallel import (
    make_mesh, shard_batch, shard_params)

import torch_mp_common as C

W = C.W


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    inputs = C.write_inputs(d)
    return {**inputs, "res": C.launch(d, "tp")}


def _jax_tp_forward(params, x, dp, tp, geom=C.JGEOM):
    jm = C.JViT(dropout=0.0, **geom)
    mesh = make_mesh(data=dp, model=tp, devices=jax.devices()[:dp * tp])
    with mesh:
        p = shard_params(params, mesh)
        xb = shard_batch({"image": x}, mesh)["image"]
        return np.asarray(jax.jit(
            lambda p, x: jm.apply({"params": p}, x))(p, xb))


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_tp_forward_matches_jax(runs, dp, tp):
    outs = C.ranks(runs["res"], dp * tp)
    got = C.assembled(outs, f"fwd_{dp}x{tp}", dp)
    assert all(int(o[f"calls_{dp}x{tp}"]) == C.JGEOM["depth"] for o in outs)
    for want in (_jax_tp_forward(runs["params"], runs["x"], dp, tp),
                 C.jax_forward(runs["params"], runs["x"])):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_indivisible_heads_keep_the_attention_whole(runs, world):
    outs = C.ranks(runs["res"], world)
    got = C.assembled(outs, "fwd3", 1)
    assert all(int(o["calls3"]) == 0 for o in outs)
    want = C.jax_forward(runs["params3"], runs["x"], C.JGEOM3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("world,key", [(2, "1x2"), (4, "2x2")])
def test_tp_gradients_match_jax(runs, world, key):
    got = C.agreed(C.ranks(runs["res"], world), f"grad_{key}")
    want = C.jax_ce_grads(runs["params"], runs["x"], runs["y"])
    assert set(got) == set(want)
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], atol=2e-5,
                                   rtol=2e-4, err_msg=path)


@pytest.mark.parametrize("world,key", [(2, "1x2"), (4, "2x2")])
def test_tp_step_matches_jax_and_the_single_process(runs, world, key):
    outs = C.ranks(runs["res"], world)
    got = C.agreed(outs, f"step_{key}")
    assert all(int(o[f"step_calls_{key}"]) == C.JGEOM["depth"]
               for o in outs)
    loss, gnorm, want = C.jax_step(runs["params"], runs["x"], runs["y"])
    assert float(got["loss"]) == pytest.approx(loss, abs=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), gnorm, rtol=1e-4)
    port = {k[2:]: v for k, v in got.items() if k.startswith("p/")}
    C.assert_params_close(port, want, atol=5e-5, rtol=1e-4)
    drop = C.agreed(outs, f"drop_{key}")
    loss, single = C.port_single_step(runs["params"], runs["x"], runs["y"],
                                      0.1)
    assert float(drop["loss"]) == pytest.approx(loss, abs=1e-5)
    C.assert_params_close({k[2:]: v for k, v in drop.items()
                           if k.startswith("p/")}, single, atol=5e-5,
                          rtol=1e-4)


def test_tp_layout_holds_megatron_slices(runs):
    """(1, 2): qkv's columns of the rank's two heads, fc1's half of the
    hidden columns, proj's and fc2's half of the rows; the rest whole;
    the Adam moments shaped alike (tests/test_sharding_config.py:126)."""
    for o in C.ranks(runs["res"], 2):
        shape = {k[len("shape/"):]: tuple(v) for k, v in o.items()
                 if k.startswith("shape/")}
        blk = "vit/block0/"
        assert shape[blk + "attn/qkv/kernel"] == (64, 96)
        assert shape[blk + "attn/qkv/bias"] == (96,)
        assert shape[blk + "attn/proj/kernel"] == (32, 64)
        assert shape[blk + "attn/proj/bias"] == (64,)
        assert shape[blk + "mlp/fc1/kernel"] == (64, 128)
        assert shape[blk + "mlp/fc2/kernel"] == (128, 64)
        assert shape["vit/patch_embed/kernel"] == (768, 64)
        assert shape["head/fc1/kernel"] == (64, 32)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_layout_and_step_match_jax(runs, world):
    outs = C.ranks(runs["res"], world)
    for o in outs:
        assert tuple(o["fsdp/shape/vit/block0/attn/qkv/kernel"]) == (
            64, 192 // world)
        assert tuple(o["fsdp_mu_qkv"]) == (64, 192 // world)
        # below the 1,024-element floor: whole
        assert tuple(o["fsdp/shape/vit/block0/attn/qkv/bias"]) == (192,)
        assert tuple(o["fsdp/shape/vit/cls_token"]) == (1, 1, 64)
    got = C.agreed(outs, "fsdp_grad")
    want = C.jax_ce_grads(runs["params"], runs["x"], runs["y"])
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], atol=2e-5,
                                   rtol=2e-4, err_msg=path)
    step = C.agreed(outs, "fsdp_step")
    loss, gnorm, want = C.jax_step(runs["params"], runs["x"], runs["y"])
    assert float(step["loss"]) == pytest.approx(loss, abs=1e-5)
    np.testing.assert_allclose(float(step["grad_norm"]), gnorm, rtol=1e-4)
    C.assert_params_close({k[2:]: v for k, v in step.items()
                           if k.startswith("p/")}, want, atol=5e-5,
                          rtol=1e-4)
