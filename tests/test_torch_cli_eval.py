"""The port's computing verbs against the JAX package's, through their
``main(argv)`` on the CPU (``--device cpu`` on the port's side):

- ``test`` and ``evaluate-all`` on a ``util_synthetic`` tree with random
  flax ViT-B/16 weights exported by JAX's ``save_torch_checkpoint``: the
  same per-image file names, scores within slice 5's bounds (1.44e-2 at
  bf16 for ``test``, flax's own eager-vs-jit spread being 1.6e-2; 1e-5 at
  f32 for ``Custom_ViT_FineTuned`` in ``evaluate-all``, the only entry
  whose weights both sides load; the others initialise differently);
- ``train`` (ViT-B/16, one step an epoch) -> ``train --resume`` ->
  ``export`` of the checkpoint directory: JAX's ``test`` verb loads the
  exported ``.pth`` and scores within the bf16 bound of the port's
  ``test`` of it;
  ``export`` refuses a missing path and ``--ema`` on a file;
- ``augment``: the counts of tests/test_integration.py and the same file
  names as JAX's verb.
"""

import csv
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from util_synthetic import make_subject_tree
from vit_spoof_detection_pda_tpu.cli import augment as jaugment
from vit_spoof_detection_pda_tpu.cli import evaluate_all as jevaluate
from vit_spoof_detection_pda_tpu.cli import test as jtest
from vit_spoof_detection_pda_tpu.models import convert as jconvert
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch.cli import augment as taugment
from vit_spoof_detection_pda_tpu_torch.cli import evaluate_all as tevaluate
from vit_spoof_detection_pda_tpu_torch.cli import export as texport
from vit_spoof_detection_pda_tpu_torch.cli import test as ttest
from vit_spoof_detection_pda_tpu_torch.cli import train as ttrain

BF16_SCORE_TOL = 1.44e-2      # slice 5's bf16 module bound
F32_SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_eval")
    make_subject_tree(root / "raw", subjects=2, per_class=4, size=64)
    make_subject_tree(root / "test", subjects=2, per_class=3, size=64)
    variables = jvit.ViTAntiSpoof().init(jax.random.PRNGKey(7),
                                         jnp.zeros((1, 224, 224, 3)))
    # spread the head so scores are not all ~0.5
    params = jax.tree.map(np.asarray, variables)["params"]
    params["head"]["fc2"]["kernel"] = params["head"]["fc2"]["kernel"] * 4
    jconvert.save_torch_checkpoint(str(root / "vit.pth"),
                                   {"params": params})
    return root


def _column(path: Path, column: str) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    key = "image_path" if "image_path" in rows[0] else "path"
    return {r[key]: float(r[column]) for r in rows}


def _only(directory: Path, pattern: str) -> Path:
    (path,) = directory.glob(pattern)
    return path


def test_test_verb_scores_match_jax(ws):
    argv = ["--checkpoint", str(ws / "vit.pth"),
            "--set", f'data.test_root="{ws / "test"}"',
            "--set", "eval.batch_size=8", "--no-plots"]
    jm = jtest.main(argv + ["--set", f'eval.output_dir="{ws / "jt"}"'])
    tm = ttest.main(argv + ["--set", f'eval.output_dir="{ws / "tt"}"',
                            "--device", "cpu"])
    want = _column(_only(ws / "jt", "per_image_results_*.csv"),
                   "probability_live")
    got = _column(_only(ws / "tt", "per_image_results_*.csv"),
                  "probability_live")
    assert list(got) == list(want) and len(got) == 12
    gap = max(abs(got[k] - want[k]) for k in want)
    assert gap <= BF16_SCORE_TOL, gap
    assert np.ptp(list(want.values())) > 0.05       # the scores spread
    assert tm["total_samples"] == jm["total_samples"] == 12
    assert sorted(p.name[:18] for p in (ws / "tt").iterdir()) == sorted(
        p.name[:18] for p in (ws / "jt").iterdir())


def test_evaluate_all_checkpoint_entry_matches_jax_at_f32(ws):
    argv = ["--checkpoint", str(ws / "vit.pth"),
            "--set", f'data.test_root="{ws / "test"}"',
            "--set", "eval.batch_size=6", "--models", "Custom_ViT_FineTuned"]
    jres = jevaluate.main(argv + ["--set", f'eval.output_dir="{ws / "je"}"'])
    tres = tevaluate.main(argv + ["--set", f'eval.output_dir="{ws / "te"}"',
                                  "--device", "cpu"])
    assert list(tres) == list(jres) == ["Custom_ViT_FineTuned"]
    name = "Custom_ViT_FineTuned"
    want = _column(ws / "je" / name / "per_image_predictions.csv",
                   "spoof_score")
    got = _column(ws / "te" / name / "per_image_predictions.csv",
                  "spoof_score")
    assert list(got) == list(want)
    gap = max(abs(got[k] - want[k]) for k in want)
    assert gap <= F32_SCORE_TOL, gap
    assert sorted(p.name for p in (ws / "te" / name).iterdir()) == sorted(
        p.name for p in (ws / "je" / name).iterdir())
    assert (ws / "te" / "model_comparison.json").exists()


def test_train_resume_export_loads_into_jax_test_verb(ws, capsys):
    """ViT-B/16 at 224 (the geometry JAX's ``test`` verb builds for a
    file), one step an epoch at B = 4: two epochs, then a third through
    ``--resume``; the export of the directory scores the same in JAX's
    ``test`` verb as in the port's."""
    data = ["--set", f'data.data_root="{ws / "aug"}"',
            "--set", "data.batch_size=4", "--set", "data.eval_batch_size=8",
            "--set", "train_aug.enabled=false", "--set", "data.num_workers=2",
            "--set", f'checkpoint.save_dir="{ws / "ckpts"}"',
            "--set", "checkpoint.save_every_epochs=1", "--device", "cpu"]
    taugment.main(["--device", "cpu",
                   "--set", f'augment.input_dir="{ws / "raw"}"',
                   "--set", f'augment.output_dir="{ws / "aug"}"',
                   "--set", "augment.live_augmentations=2",
                   "--set", "augment.spoof_augmentations=1",
                   "--set", "augment.batch_size=8",
                   "--set", "augment.img_size=32"])
    out = ws / "exported.pth"
    try:
        ttrain.main(data + ["--set", "optim.num_epochs=2",
                            "--max-steps-per-epoch", "1"])
        steps = [int(p.name) for p in (ws / "ckpts").iterdir()
                 if p.name.isdigit()]
        assert steps and max(steps) == 2
        ttrain.main(data + ["--set", "optim.num_epochs=3",
                            "--max-steps-per-epoch", "1", "--resume"])
        from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (
            list_checkpoints)
        assert list_checkpoints(str(ws / "ckpts"))[-1][0] == 3

        texport.main([str(ws / "ckpts"), str(out)])
        assert "exported 156 tensors" in capsys.readouterr().out
        argv = ["--checkpoint", str(out), "--no-plots",
                "--set", f'data.test_root="{ws / "test"}"',
                "--set", "eval.batch_size=12"]
        jtest.main(argv + ["--set", f'eval.output_dir="{ws / "jx"}"'])
        ttest.main(argv + ["--set", f'eval.output_dir="{ws / "tx"}"',
                           "--device", "cpu"])
    finally:
        # three ViT-B/16 states with AdamW moments are ~3 GB on disk
        shutil.rmtree(ws / "ckpts", ignore_errors=True)
        out.unlink(missing_ok=True)
    want = _column(_only(ws / "jx", "per_image_results_*.csv"),
                   "probability_live")
    got = _column(_only(ws / "tx", "per_image_results_*.csv"),
                  "probability_live")
    assert list(got) == list(want)
    gap = max(abs(got[k] - want[k]) for k in want)
    assert gap <= BF16_SCORE_TOL, gap


def test_export_refuses_a_missing_path_and_ema_on_a_file(ws, capsys):
    with pytest.raises(SystemExit) as e:
        texport.main([str(ws / "nope"), str(ws / "x.pth")])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        texport.main([str(ws / "vit.pth"), str(ws / "x.pth"), "--ema"])
    assert e.value.code == 2
    assert "--ema" in capsys.readouterr().err


def test_augment_matches_jax_counts_and_names(ws):
    common = ["--set", f'augment.input_dir="{ws / "raw"}"',
              "--set", "augment.live_augmentations=2",
              "--set", "augment.spoof_augmentations=1",
              "--set", "augment.batch_size=8", "--set", "augment.img_size=32"]
    jtotal = jaugment.main(common + [
        "--set", f'augment.output_dir="{ws / "jaug"}"'])
    ttotal = taugment.main(common + [
        "--set", f'augment.output_dir="{ws / "taug"}"', "--device", "cpu"])
    assert ttotal == jtotal == 24 + 16
    for cls, n in (("live", 24), ("spoof", 16)):
        names = sorted(p.name for p in (ws / "taug" / cls).glob("*.jpg"))
        assert len(names) == n
        assert names == sorted(p.name for p in (ws / "jaug" / cls).glob(
            "*.jpg"))
