"""A run with the timed path broken underneath comes out not correct.

Each cell runs on the CPU at a tiny size (``tiny.py``), the chip's look
skipped, once sound and once for each fault the cell can have, planted
in the program where it produces its answer: in the scoring cells an
answer altered and half of the batch left out (its scores zero); in
training half of the batch left out (its loss the mean of the other
half) and a step that leaves the state unchanged.  Training hands on a
state, not answers, so it has no answer to alter.  One chip holds each
cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

import pytest

from padbench.tests import tiny

FS = "vit_spoof_detection_pda_tpu_torch.models.fastserve"
RUNNER = "vit_spoof_detection_pda_tpu_torch.eval.runner"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def _altered(p):
    p = p.clone()
    p[0] = (p[0] + 0.5) % 1.0
    return p


def _half(p):
    p = p.clone()
    p[p.shape[0] // 2:] = 0.0
    return p


def _wrap_scores(monkeypatch, module, name, change):
    import importlib
    mod = importlib.import_module(module)
    orig = getattr(mod, name)

    def broken(*a, **kw):
        out = orig(*a, **kw)
        if isinstance(out, dict):
            return dict(out, prob1=change(out["prob1"]))
        return change(out)

    monkeypatch.setattr(mod, name, broken)


SCORE_FAULTS = {"altered_answer": _altered, "half_batch": _half}


def test_sound_runs_are_correct(root):
    for cell in ("score.vit_b16_mlp_head.b128",
                 "eval_f32.vit_b16_linear_head.b32",
                 "train.vit_b16_mlp_head.b128"):
        r = tiny.run(root, cell, seconds=0.3)
        assert r["correct"], (cell, r["checks"])


@pytest.mark.parametrize("fault", sorted(SCORE_FAULTS))
def test_score_fault(root, monkeypatch, fault):
    _wrap_scores(monkeypatch, FS, "serving_forward", SCORE_FAULTS[fault])
    r = tiny.run(root, "score.vit_b16_mlp_head.b128", seconds=0.3)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(SCORE_FAULTS))
def test_eval_f32_fault(root, monkeypatch, fault):
    _wrap_scores(monkeypatch, RUNNER, "infer_body", SCORE_FAULTS[fault])
    r = tiny.run(root, "eval_f32.vit_b16_linear_head.b32", seconds=0.3)
    assert not r["correct"], r["checks"]


def _unchanged(monkeypatch):
    from vit_spoof_detection_pda_tpu_torch.train import state
    monkeypatch.setattr(state.Optimizer, "update",
                        lambda self, grads, st, params, norm_fn=None: True)


def _half_loss(monkeypatch):
    from vit_spoof_detection_pda_tpu_torch.ops import losses
    orig = losses.focal_loss

    def half(logits, labels, **kw):
        h = logits.shape[0] // 2
        return orig(logits[:h], labels[:h], **kw)

    monkeypatch.setattr(losses, "focal_loss", half)


TRAIN_FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_loss}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault(root, monkeypatch, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    r = tiny.run(root, "train.vit_b16_mlp_head.b128", seconds=0.3)
    assert not r["correct"], r["checks"]
