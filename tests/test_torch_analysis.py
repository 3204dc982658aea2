"""The port's analysis layer (``analysis/``, the ``analyze`` verb) against
the JAX package's on one seeded results tree: four models' harness files
written by the JAX harness from numpy-seeded scores (with ties, and one
weak model), images on disk for the failed-case miner.

- distributions, failed cases, summary, calibration: every CSV byte-equal
  to JAX's pandas output, every JSON equal within 1e-12 (the summary's
  date apart);
- calibration math and the attention rollout within 1e-9 of JAX's, the
  captured attention probabilities within 1e-5, the on-device rollout
  within 1e-5 of the float64 host rollout, capture off again after;
- the CSV reader types columns and parses floats as pandas does;
- ``xprof`` on a CPU ``torch.profiler`` trace and on a hand-written one;
- the figure suite's names and outcomes equal JAX's;
- ``analyze --calibration`` through both ``__main__``s writes the same
  file set, byte-equal apart from the summary's date.
"""

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from vit_spoof_detection_pda_tpu import __main__ as jmain
from vit_spoof_detection_pda_tpu.analysis import attention_maps as jattn
from vit_spoof_detection_pda_tpu.analysis import calibration as jcal
from vit_spoof_detection_pda_tpu.analysis import distributions as jdist
from vit_spoof_detection_pda_tpu.analysis import failed_cases as jfail
from vit_spoof_detection_pda_tpu.analysis import figures as jfig
from vit_spoof_detection_pda_tpu.analysis import summary as jsum
from vit_spoof_detection_pda_tpu.data.manifest import Record as JRecord
from vit_spoof_detection_pda_tpu.eval import harness as jharness
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch import __main__ as tmain
from vit_spoof_detection_pda_tpu_torch.analysis import attention_maps as tattn
from vit_spoof_detection_pda_tpu_torch.analysis import calibration as tcal
from vit_spoof_detection_pda_tpu_torch.analysis import distributions as tdist
from vit_spoof_detection_pda_tpu_torch.analysis import failed_cases as tfail
from vit_spoof_detection_pda_tpu_torch.analysis import figures as tfig
from vit_spoof_detection_pda_tpu_torch.analysis import summary as tsum
from vit_spoof_detection_pda_tpu_torch.analysis import tables
from vit_spoof_detection_pda_tpu_torch.analysis import xprof as txprof
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit

MODELS = {"Custom_ViT_FineTuned": 3.0, "Base_ViT_Pretrained": 0.3,
          "ResNet50_Pretrained": 1.5, "SigNet_F": 0.8}   # separations
N = 160


def _write_tree(root: Path):
    rng = np.random.default_rng(0)
    img_dir = root.parent / f"{root.name}_images"
    img_dir.mkdir(parents=True)
    labels = rng.integers(0, 2, N)                  # canonical 1 = live
    records = []
    for i, y in enumerate(labels):
        path = img_dir / f"{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(path)
        records.append(JRecord(str(path), int(y), f"s{i % 5}"))
    y_spoof = 1 - labels
    results = {}
    for name, sep in MODELS.items():
        z = sep * (y_spoof - 0.5) * 2 + rng.standard_normal(N)
        scores = 1.0 / (1.0 + np.exp(-z))
        scores[::17] = 0.5                          # ties at the cut
        scores[1::23] = scores[2]                   # and elsewhere
        ev = jharness.evaluate_scores(y_spoof, scores)
        results[name] = jharness.save_model_results(
            name, records, y_spoof, scores, ev, root)
    jharness.create_comparison_reports(results, root, n_samples=N)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("analysis") / "results")


@pytest.fixture
def pair(tree, tmp_path):
    """Two copies of the seeded tree: (JAX's, the port's)."""
    a, b = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(tree, a)
    shutil.copytree(tree, b)
    return a, b


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in root.rglob("*")
            if p.is_file()}


def _close(a, b, path=""):
    """JSON values equal, floats within 1e-12."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-12, (path, a, b)
    else:
        assert a == b, path


def _same_trees(a: Path, b: Path, *, skip_keys=("evaluation_date",)):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        if rel.endswith(".json"):
            ja, jb = (json.loads(fa[rel].read_text()),
                      json.loads(fb[rel].read_text()))
            for k in skip_keys:
                if isinstance(ja, dict):
                    ja.pop(k, None)
                    jb.pop(k, None)
            _close(ja, jb, rel)
        elif not rel.endswith(".png"):
            assert fa[rel].read_bytes() == fb[rel].read_bytes(), rel


ANALYZERS = {
    "distributions": (jdist.analyze_score_distributions,
                      tdist.analyze_score_distributions),
    "failed_cases": (lambda d: jfail.extract_failed_cases(d, top_n=7),
                     lambda d: tfail.extract_failed_cases(d, top_n=7)),
    "summary": (jsum.generate_summary_statistics,
                tsum.generate_summary_statistics),
    "calibration": (jcal.analyze_calibration, tcal.analyze_calibration),
    "calibration_quantile": (
        lambda d: jcal.analyze_calibration(d, n_bins=7, strategy="quantile"),
        lambda d: tcal.analyze_calibration(d, n_bins=7, strategy="quantile")),
}


@pytest.mark.parametrize("name", list(ANALYZERS))
def test_analyzer_writes_jax_bytes(pair, name):
    ja, tb = pair
    jfn, tfn = ANALYZERS[name]
    want, got = jfn(str(ja)), tfn(str(tb))
    want, got = json.loads(json.dumps(want)), json.loads(json.dumps(got))
    if name == "summary":
        want.pop("evaluation_date")
        got.pop("evaluation_date")
    _close(want, got)
    _same_trees(ja, tb)


def test_distributions_then_failed_cases_on_an_empty_tree(tmp_path):
    for fn in (tdist.analyze_score_distributions, tfail.extract_failed_cases):
        assert fn(str(tmp_path)) == {}
    assert json.loads((tmp_path / "score_distribution_analysis.json")
                      .read_text()) == {}


@pytest.mark.parametrize("strategy", ["uniform", "quantile"])
def test_calibration_math_matches_jax(strategy):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, 500)
    s = np.clip(0.3 * y + 0.7 * rng.random(500), 0, 1)
    for j, t in zip(jcal.reliability_curve(s, y, n_bins=10, strategy=strategy),
                    tcal.reliability_curve(s, y, n_bins=10,
                                           strategy=strategy)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-9)
    _close(jcal.calibration_errors(s, y, strategy=strategy),
           tcal.calibration_errors(s, y, strategy=strategy))
    assert abs(jcal.fit_temperature(s, y) - tcal.fit_temperature(s, y)) \
        <= 1e-9
    np.testing.assert_allclose(tcal.apply_temperature(s, 1.7),
                               jcal.apply_temperature(s, 1.7), atol=1e-9)


def test_rollout_matches_jax():
    rng = np.random.default_rng(2)
    probs = [rng.random((3, 2, 17, 17)) for _ in range(3)]
    probs = [p / p.sum(-1, keepdims=True) for p in probs]
    np.testing.assert_allclose(tattn.attention_rollout(probs),
                               jattn.attention_rollout(probs), atol=1e-9)
    np.testing.assert_allclose(tattn.cls_patch_relevance(probs),
                               jattn.cls_patch_relevance(probs), atol=1e-9)
    with pytest.raises(ValueError, match="not square"):
        tattn.cls_patch_relevance([p[..., :16, :16] for p in probs])


@pytest.fixture(scope="module")
def vit_pair():
    geom = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, hidden=16)
    jm = jvit.ViTAntiSpoof(**geom)
    variables = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
    tm = tconvert.load_jax_params(tvit.ViTAntiSpoof(**geom, img_size=32),
                                  jax.tree.map(np.asarray, variables))
    images = np.random.default_rng(5).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    return jm, variables, tm, images


def test_capture_probs_match_jax_and_capture_turns_off(vit_pair):
    jm, variables, tm, images = vit_pair
    tm.train()
    want = jattn.capture_attention_probs(jm, variables, jnp.asarray(images))
    got = tattn.capture_attention_probs(tm, images)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 2, 17, 17) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-5)
    attns = [b.attn for b in tm.vit.blocks]
    assert not any(a.capture for a in attns)
    assert all(a.attn_probs is None for a in attns)
    assert tm.training                               # the mode restored


def test_device_rollout_matches_host_rollout(vit_pair):
    jm, variables, tm, images = vit_pair
    host = tattn.cls_patch_relevance(
        tattn.capture_attention_probs(tm, images))
    dev = tattn.cls_patch_relevance_device(tm, images)
    assert dev.shape == (3, 4, 4) and dev.dtype == np.float64
    np.testing.assert_allclose(dev, host, atol=1e-5)
    want = jattn.cls_patch_relevance_device(jm, variables,
                                            jnp.asarray(images))
    np.testing.assert_allclose(dev, want, atol=1e-5)


def test_rollout_refuses_modules_without_capture():
    with pytest.raises(ValueError, match="ViT family"):
        tattn.capture_attention_probs(tvit.ViTLinearHead(
            patch_size=8, embed_dim=32, depth=1, num_heads=2, img_size=16),
            np.zeros((1, 16, 16, 3), np.float32))


def test_csv_reader_types_and_parses_floats_as_pandas(tmp_path):
    rng = np.random.default_rng(3)
    x64 = rng.random(3000)                             # 17-digit reprs
    frame = pd.DataFrame({
        "f64": x64, "f32": x64.astype(np.float32), "i": np.arange(3000),
        "s": [f"p{i}.png" for i in range(3000)],
        "b": rng.random(3000) > 0.5,
        "mixed": [1.5 if i % 7 else np.nan for i in range(3000)],
        "tiny": rng.standard_normal(3000) * 1e-30})
    path = tmp_path / "t.csv"
    frame.to_csv(path, index=False)
    got = tables.read_csv(path)
    want = pd.read_csv(path)
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(got[c].view(np.int64)[~np.isnan(w)],
                                          w.view(np.int64)[~np.isnan(w)])
            assert (np.isnan(got[c]) == np.isnan(w)).all()
        else:
            assert got[c].tolist() == w.tolist(), c
    # Python's float() is correctly rounded; pandas' parser is not past 15
    # digits, and the reader follows pandas
    strings = x64.astype(str)
    assert any(float(s) != tables.pandas_float(s) for s in strings)


def test_xprof_on_a_cpu_trace_and_a_hand_written_one(tmp_path):
    from vit_spoof_detection_pda_tpu_torch.utils.profiling import (
        profile_trace)
    with profile_trace(str(tmp_path / "cpu")):
        a = torch.randn(32, 32)
        (a @ a).sum()
    s = txprof.summarize_trace(str(tmp_path / "cpu"))
    assert s["n_ops"] == 0 and s["total_device_ms"] == 0.0
    assert s["by_category"] == [] and s["top_ops"] == []

    events = [{"ph": "X", "cat": "kernel", "name": "gemm_tma_kernel<1>",
               "dur": 120.0},
              {"ph": "X", "cat": "kernel", "name": "gemm_tma_kernel<1>",
               "dur": 80.0},
              {"ph": "X", "cat": "kernel", "name": "layernorm_kernel<false>",
               "dur": 30.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "dur": 50.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 999.0},
              {"ph": "i", "cat": "kernel", "name": "marker"}]
    (tmp_path / "gpu").mkdir()
    (tmp_path / "gpu" / "trace.json").write_text(
        json.dumps({"traceEvents": events}))
    s = txprof.summarize_trace(str(tmp_path / "gpu"), steps=2, top=2)
    assert s["n_ops"] == 3 and s["per_step"]
    assert s["total_device_ms"] == pytest.approx(0.14)
    assert [(r["category"], r["ms"]) for r in s["by_category"]] == [
        ("kernel", pytest.approx(0.115)), ("gpu_memcpy", pytest.approx(0.025))]
    assert s["top_ops"] == [
        {"op": "gemm_tma_kernel<1>", "category": "kernel", "execs": 2,
         "ms": pytest.approx(0.1)},
        {"op": "Memcpy HtoD", "category": "gpu_memcpy", "execs": 1,
         "ms": pytest.approx(0.025)}]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        txprof.print_summary(s)
    assert "gemm_tma_kernel<1>" in out.getvalue()
    with pytest.raises(FileNotFoundError):
        txprof.summarize_trace(str(tmp_path / "none"))


@pytest.fixture
def low_dpi(monkeypatch):
    """Figures saved at 20 dpi (the suite asks for 300): the same calls at
    a fraction of the rendering time."""
    from matplotlib.figure import Figure
    save = Figure.savefig

    def savefig(self, *a, **k):
        k["dpi"] = 20
        return save(self, *a, **k)

    monkeypatch.setattr(Figure, "savefig", savefig)


def test_figures_match_jax_names(pair, tmp_path, low_dpi):
    ja, tb = pair
    for d, fail in ((ja, jfail), (tb, tfail)):
        fail.extract_failed_cases(str(d), top_n=8)
    jdist.analyze_score_distributions(str(ja))
    tdist.analyze_score_distributions(str(tb))
    want = jfig.generate_all_figures(str(ja), str(tmp_path / "jf"))
    got = tfig.generate_all_figures(str(tb), str(tmp_path / "tf"))
    assert list(got) == list(want)
    for k in want:
        kind = lambda v: (None if v is None else "error"     # noqa: E731
                          if str(v).startswith("ERROR") else Path(v).name)
        assert kind(got[k]) == kind(want[k]), (k, got[k], want[k])
    assert sorted(p.name for p in (tmp_path / "tf").iterdir()) == sorted(
        p.name for p in (tmp_path / "jf").iterdir())
    assert len(list((tmp_path / "tf").iterdir())) >= 10


def test_augmentation_grids_take_jax_names(tmp_path, low_dpi):
    """The augmentation grids (the port's heavy tier on the CPU) under the
    JAX generator's keys and file names, first in the suite."""
    sample = np.random.default_rng(6).random((24, 24, 3)).astype(np.float32)
    got = tfig.generate_all_figures(str(tmp_path), str(tmp_path / "f"),
                                    sample_image=sample)
    assert list(got)[:2] == ["augmentation_grid", "augmentation_2x2"]
    assert [Path(got[k]).name for k in list(got)[:2]] == [
        "figure_augmentation_2x4.png", "figure_augmentation_2x2.png"]


def test_analyze_verbs_write_the_same_files(pair, monkeypatch, low_dpi):
    ja, tb = pair
    argv = ["analyze", "--calibration", "--top-n", "5",
            "--calibration-bins", "9"]
    monkeypatch.setattr(sys, "argv", ["jax"] + argv + ["--results-dir",
                                                       str(ja)])
    assert jmain.main() == 0
    assert tmain.main(argv + ["--results-dir", str(tb)]) == 0
    assert (tb / "calibration_reliability.png").exists()
    assert (tb / "final_summary.json").exists()
    _same_trees(ja, tb)
