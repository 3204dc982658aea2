"""The port's ResNet50 against the flax ResNet50 (f32 logits, eval-mode
BatchNorm on the JAX ``batch_stats``), and its torchvision key set.

Weights: a flax init with its batch statistics redrawn from a numpy seed
(means N(0, 0.1), variances U(0.5, 1.5)), carried across through
``models/convert.py::resnet50_to_torch``.  The key set is torchvision's:
the JAX package's own ``resnet50_from_torchvision`` (which reads
torchvision names) maps the port's state dict back onto the flax tree.

Tolerance: f32 logits at atol 1e-4 / rtol 1e-4 (53 convolutions summed
in other orders; XLA and PyTorch also write the BatchNorm affine
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import convert as jconvert
from vit_spoof_detection_pda_tpu.models.resnet import ResNet50 as JResNet50
from vit_spoof_detection_pda_tpu_torch.device import exact_f32_matmul
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models.resnet import ResNet50


@pytest.fixture(scope="module")
def flax_resnet():
    jm = JResNet50()
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def redraw(tree):
        return {k: redraw(v) if "mean" not in v else {
            "mean": rng.normal(0, 0.1, v["mean"].shape).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)}
            for k, v in tree.items()}

    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": redraw(stats)}
    return jm, variables


def test_logits_match_flax_f32(flax_resnet):
    jm, variables = flax_resnet
    x = np.random.default_rng(1).standard_normal((3, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tm = tconvert.load_jax_params(ResNet50().eval(), variables)
    with torch.no_grad(), exact_f32_matmul():
        got = tm(torch.tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_state_dict_is_torchvision_keyed_and_loads_strict(flax_resnet):
    _jm, variables = flax_resnet
    sd = tconvert.resnet50_to_torch(variables)
    tm = ResNet50()
    assert sorted(sd) == sorted(tm.state_dict())
    assert "layer1.0.downsample.0.weight" in sd
    assert "layer4.2.bn3.running_var" in sd
    assert sd["conv1.weight"].shape == (64, 3, 7, 7)
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                       strict=True)
    # the JAX converter reads torchvision's names: it rebuilds the tree
    back = jconvert.resnet50_from_torchvision(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf),
                                      err_msg=str(path))


def test_port_converter_takes_a_torchvision_state_dict(flax_resnet):
    _jm, variables = flax_resnet
    sd = {k: torch.tensor(v) for k, v in
          tconvert.resnet50_to_torch(variables).items()}
    sd["fc.weight"] = torch.zeros(1000, 2048)        # an ImageNet head
    sd["fc.bias"] = torch.zeros(1000)
    out = tconvert.resnet50_from_torchvision(sd)
    assert sorted(out) == sorted(ResNet50().state_dict())
    assert torch.equal(out["layer2.0.conv2.weight"], sd["layer2.0.conv2.weight"])
    del sd["layer3.1.bn2.running_mean"]
    with pytest.raises(KeyError):
        tconvert.resnet50_from_torchvision(sd)


def test_eval_mode_reads_running_stats_and_train_mode_does_not(flax_resnet):
    _jm, variables = flax_resnet
    tm = tconvert.load_jax_params(ResNet50(), variables)
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a = tm.eval()(x)
        b = tm.eval()(x)
        c = tm.train()(x)
    assert torch.equal(a, b) and not torch.allclose(a, c)
