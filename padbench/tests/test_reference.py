"""The plain reference agrees with the port at a tiny size on the CPU,
both at float32: the scoring forward of both heads, and three training
steps with the same dropout masks."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from padbench import check, generate, port, weights
from padbench.harness import Manifest
from padbench.reference import vit as ref
from padbench.tests.tiny import TINY, REPO

CPU = torch.device("cpu")


def _cfg(name):
    cfg = Manifest(REPO).config(name)
    cfg.update({k: v for k, v in TINY.items()
                if k != "head_hidden_size" or cfg["head"] == "mlp"})
    return cfg


@pytest.mark.parametrize("name", ["vit_b16_mlp_head", "vit_b16_linear_head"])
def test_scores_match_the_port_module(name):
    from vit_spoof_detection_pda_tpu_torch.eval.runner import make_infer_fn
    cfg = _cfg(name)
    w = weights.make(cfg, 7, CPU)
    images = generate.faces(7, 6, cfg["image_size"], CPU)
    infer = make_infer_fn(port.module(cfg, w, CPU), input_dtype=torch.float32)
    got = infer(torch.from_numpy(images))["prob1"].numpy()
    want = ref.p_live(w, torch.from_numpy(images), cfg).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_training_matches_the_port_step_at_f32():
    import padbench.drivers.train as drv
    cfg = dict(_cfg("vit_b16_mlp_head"), dtype="float32")
    b = 8
    images = generate.faces(9, 3 * b, cfg["image_size"], CPU)
    labels = generate.labels(9, 3 * b, "1:3.87")
    seed = generate.sub_seed(9, 4)
    w = weights.make(cfg, 9, CPU)
    state, step = drv.build(cfg, w, CPU, seed, "hidden")
    p0 = drv.host_copy(state, cfg, state.leaves())
    losses, g1 = [], None
    for k in range(3):
        batch = {"image": images[k * b:(k + 1) * b],
                 "label": labels[k * b:(k + 1) * b]}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if k == 0:
            g1 = drv.host_copy(state, cfg, state.opt_state["mu"],
                               1.0 / (1.0 - cfg["optimizer"]["beta1"]))
    d3 = {k: v - p0[k]
          for k, v in drv.host_copy(state, cfg, state.leaves()).items()}
    feed = [(torch.from_numpy(images[k * b:(k + 1) * b]),
             torch.from_numpy(labels[k * b:(k + 1) * b])) for k in range(3)]
    want = ref.train_steps(w, feed, [drv.step_seed(seed, s) for s in range(3)],
                           cfg, cfg["optimizer"])
    gaps = check.training_gaps(g1, d3, want, w)
    assert max(abs(p - r) / r for p, r in zip(losses, want["loss"])) < 1e-5
    assert gaps["grad_diff"] < 1e-4
    assert gaps["change_gap"] < 1e-3
