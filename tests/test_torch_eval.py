"""The port's eval slice (``eval/runner.py``, ``eval/single.py``,
``eval/harness.py``) against the JAX package's on ``tests/util_synthetic.py``
trees, with the same weights on both sides.

- The artifact writers: fed the same labels and scores, every CSV, JSON
  and text file is byte-equal to the JAX (pandas) writer's, apart from
  the timestamps in file names and the timestamp lines.
- A deterministic model (logits [0, c] with c in {-200, 0, 200} from the
  image's brightness, so P(live) is exactly 0, 0.5 or 1 in both
  frameworks): ``run_single_model_eval`` and ``run_cross_model_eval``
  write byte-equal artifact sets end to end.
- A small ViT (f32, weights carried across): ``run_inference`` scores
  within 1e-5 of JAX's (the same f32 forward summed in another order),
  and the written metrics equal ``parity`` on the port's scores.
- The registry models under ``run_cross_model_eval`` at 32x32 with
  weights carried across as checkpoint files: per-image spoof scores
  within 1e-4 of JAX's (ViT-B/16 and ResNet50, 12 and 53 f32 layers).
"""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from vit_spoof_detection_pda_tpu.data import scan_test as jscan_test
from vit_spoof_detection_pda_tpu.data.manifest import Record as JRecord
from vit_spoof_detection_pda_tpu.eval import harness as jharness
from vit_spoof_detection_pda_tpu.eval import run_inference as jrun_inference
from vit_spoof_detection_pda_tpu.eval import single as jsingle
from vit_spoof_detection_pda_tpu.metrics import parity as jparity
from vit_spoof_detection_pda_tpu.models import convert as jconvert
from vit_spoof_detection_pda_tpu.models import resnet as jresnet
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch.data.manifest import Record, scan_test
from vit_spoof_detection_pda_tpu_torch.eval import harness as tharness
from vit_spoof_detection_pda_tpu_torch.eval import runner as trunner
from vit_spoof_detection_pda_tpu_torch.eval import single as tsingle
from vit_spoof_detection_pda_tpu_torch.eval import (run_cross_model_eval,
                                                    run_inference,
                                                    run_single_model_eval)
from vit_spoof_detection_pda_tpu_torch.metrics import parity as tparity
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit

from util_synthetic import make_subject_tree

STAMPS = ("evaluation_timestamp", "comparison_timestamp", "Evaluation Date")


def _masked(path: Path) -> bytes:
    lines = path.read_bytes().splitlines(keepends=True)
    return b"".join(b"<stamp>\n" if any(s.encode() in ln for s in STAMPS)
                    else ln for ln in lines)


def _same_files(a: Path, b: Path):
    """Every file under ``a`` and ``b`` pairs up (timestamps in names
    removed) and is byte-equal apart from timestamp lines; PNGs only have
    to exist on both sides."""
    def key(p):
        name = p.name
        for pre in ("test_metrics_", "per_image_results_", "confusion_matrix_",
                    "roc_curve_", "per_subject_results_", "test_summary_"):
            if name.startswith(pre) and name[len(pre):len(pre) + 8].isdigit():
                name = pre + p.suffix
        return str(p.parent.relative_to(a if p.is_relative_to(a) else b)
                   / name)

    fa = {key(p): p for p in a.rglob("*") if p.is_file()}
    fb = {key(p): p for p in b.rglob("*") if p.is_file()}
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if k.endswith(".png"):
            continue
        assert _masked(fa[k]) == _masked(fb[k]), k
    return sorted(fa)


def _records(n=23, seed=0):
    rng = np.random.default_rng(seed)
    subj = [f"s{i}" for i in rng.integers(0, 5, n)]
    subj[3] = ""                                   # a record without subject
    labels = rng.integers(0, 2, n)
    paths = [f"data/{s or 'x'}/{'live' if y else 'spoof'}/{i}, q\".png"
             for i, (s, y) in enumerate(zip(subj, labels))]
    both = [(cls(p, int(y), s or None, None)) for cls in (JRecord, Record)
            for p, y, s in zip(paths, labels, subj)]
    return both[:n], both[n:], labels.astype(np.int32)


def test_single_writers_byte_equal(tmp_path):
    jrec, trec, y = _records()
    rng = np.random.default_rng(1)
    prob = rng.random(len(y)).astype(np.float32)
    prob[:4] = [0.5, 1.0, 0.0, 1e-8]
    pred = (prob > 0.5).astype(np.int32)
    for mod, recs, d in ((jsingle, jrec, "jax"), (tsingle, trec, "port")):
        metrics, cm = jparity.calculate_metrics(y, pred, prob)
        mod._save_results(metrics, cm, y, pred, prob, recs, tmp_path / d,
                          "ckpt.pth", True)
    names = _same_files(tmp_path / "jax", tmp_path / "port")
    assert len(names) == 7 and "confusion_matrix_.png" in names


@pytest.mark.parametrize("case", ["random", "single_class"])
def test_harness_writers_byte_equal(tmp_path, case):
    jrec, trec, y = _records(31, seed=2)
    rng = np.random.default_rng(3)
    scores = rng.random(len(y)).astype(np.float32).astype(np.float64)
    if case == "single_class":
        y = np.ones_like(y)
    for mod, recs, d in ((jharness, jrec, "jax"), (tharness, trec, "port")):
        out = tmp_path / d
        ev = mod.evaluate_scores(y, scores)
        s = mod.save_model_results("M1", recs, y, scores, ev, out)
        s2 = mod.save_model_results("M2", recs, y, 1.0 - scores,
                                    mod.evaluate_scores(y, 1.0 - scores), out)
        mod.create_comparison_reports({"M1": s, "M2": s2}, out, len(recs))
    _same_files(tmp_path / "jax", tmp_path / "port")


class JBright(nn.Module):
    """P(live) exactly 0, 0.5 or 1 from the image's brightness."""

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        _ = self.param("dummy", nn.initializers.zeros, (1,))
        m = jnp.mean(x, axis=(1, 2, 3))
        c = jnp.where(m > 0.3, 200.0, jnp.where(m < -0.3, -200.0, 0.0))
        return jnp.stack([jnp.zeros_like(c), c], axis=-1)


class TBright(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dummy = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        m = x.mean(dim=(1, 2, 3))
        c = torch.where(m > 0.3, 200.0, torch.where(m < -0.3, -200.0, 0.0))
        return torch.stack([torch.zeros_like(c), c], dim=-1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    make_subject_tree(root, subjects=3, per_class=4, size=32)
    # a mid-grey image scores exactly 0.5 in both
    from PIL import Image
    Image.fromarray(np.full((32, 32, 3), 120, np.uint8)).save(
        root / "subj0" / "live" / "grey.png")
    return root


def test_deterministic_model_single_eval_byte_equal(tree, tmp_path):
    jrec, trec = jscan_test(str(tree)), scan_test(str(tree))
    assert [r.path for r in jrec] == [r.path for r in trec]
    jm = jsingle.run_single_model_eval(
        JBright(), {"params": {"dummy": jnp.zeros((1,))}}, jrec,
        output_dir=str(tmp_path / "jax"), batch_size=5, img_size=32,
        checkpoint_name="bright", write_plots=False)
    tm = run_single_model_eval(TBright(), trec,
                               output_dir=str(tmp_path / "port"),
                               batch_size=5, img_size=32,
                               checkpoint_name="bright", write_plots=False)
    assert jm[0] == tm[0]
    assert sorted(jm[1]) == sorted(tm[1])
    _same_files(tmp_path / "jax", tmp_path / "port")
    with open(tm[1]["per_image"]) as f:
        probs = {r["probability_live"] for r in csv.DictReader(f)}
    assert probs == {"0.0", "0.5", "1.0"}


def test_deterministic_model_cross_eval_byte_equal(tree, tmp_path,
                                                   monkeypatch):
    jrec, trec = jscan_test(str(tree)), scan_test(str(tree))
    monkeypatch.setattr(jharness, "build_model", lambda name, **kw: (
        JBright(), {"params": {"dummy": jnp.zeros((1,))}}))
    monkeypatch.setattr(tharness, "build_model",
                        lambda name, **kw: TBright())
    names = ["SigNet_F", "ResNet50_Pretrained"]
    jres = jharness.run_cross_model_eval(
        jrec, output_dir=str(tmp_path / "jax"), model_names=names,
        batch_size=4, img_size=32)
    tres = run_cross_model_eval(trec, output_dir=str(tmp_path / "port"),
                                model_names=names, batch_size=4,
                                img_size=32, device="cpu")
    assert list(tres) == list(jres) == names
    files = _same_files(tmp_path / "jax", tmp_path / "port")
    assert "SigNet_F/threshold_analysis.csv" in files
    assert "comparison_report.txt" in files


def test_small_vit_scores_and_metrics(tree, tmp_path):
    geom = dict(patch_size=16, embed_dim=64, depth=2, num_heads=4, hidden=16)
    jm = jvit.ViTAntiSpoof(**geom)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = tconvert.load_jax_params(
        tvit.ViTAntiSpoof(**geom, img_size=32), jax.tree.map(np.asarray,
                                                             variables))
    jrec, trec = jscan_test(str(tree)), scan_test(str(tree))
    want = jrun_inference(jm, variables, jrec, batch_size=5, img_size=32)
    got = run_inference(tm, trec, batch_size=5, img_size=32)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["prob1"], want["prob1"], atol=1e-5)
    assert got["prob1"].dtype == np.float32 and got["pred"].dtype == np.int32
    metrics, paths = run_single_model_eval(tm, trec, output_dir=str(
        tmp_path), batch_size=5, img_size=32)
    want_m, _ = tparity.calculate_metrics(got["labels"], got["pred"],
                                          got["prob1"])
    assert metrics == want_m
    with open(paths["metrics"]) as f:
        row = next(csv.DictReader(f))
    assert float(row["auc"]) == want_m["auc"]
    assert int(row["tp"]) == want_m["tp"]


def test_infer_fn_threshold_temperature_and_float_input():
    m = TBright()
    u8 = torch.tensor(np.random.default_rng(4).integers(
        0, 256, (6, 8, 8, 3), dtype=np.uint8))
    base = trunner.make_infer_fn(m)(u8)
    f01 = trunner.make_infer_fn(m)(u8.float() / 255.0)
    assert torch.equal(base["prob1"], f01["prob1"])
    cut = trunner.make_infer_fn(m, threshold=0.6)(u8)
    assert torch.equal(cut["pred"], (base["prob1"] > 0.6).int())
    hot = trunner.make_infer_fn(m, temperature=400.0)(u8)
    assert set(hot["prob1"].tolist()) <= {0.5, float(torch.sigmoid(
        torch.tensor(0.5))), float(torch.sigmoid(torch.tensor(-0.5)))}
    with pytest.raises(ValueError, match="temperature"):
        trunner.make_infer_fn(m, temperature=0.0)


def test_score_batches_pads_the_tail_and_keeps_order():
    seen = []

    def infer(x):
        seen.append(tuple(x.shape))
        v = x[:, 0, 0, 0].float()
        return {"prob1": v, "pred": (v > 100).int()}

    imgs = np.arange(7, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.uint8)
    order = np.array([6, 5, 4, 3, 2, 1, 0])
    batches = [{"image": imgs[order[i:i + 3]], "index": order[i:i + 3]}
               for i in range(0, 7, 3)]
    prob1, pred = trunner.score_batches(infer, batches, 7, batch_size=3,
                                        device="cpu")
    assert seen == [(3, 2, 2, 3)] * 3
    np.testing.assert_array_equal(prob1, np.arange(7, dtype=np.float32))
    assert pred.dtype == np.int32


def test_mesh_and_fastserve_options_raise():
    # fastserve scoring over a data mesh landed (serving_forward_sharded,
    # tests/test_torch_sharded_serving.py); over a model axis it is
    # ROADMAP Queue 1 item 9b
    from types import SimpleNamespace

    tp = SimpleNamespace(mesh_dim_names=("data", "model"),
                         mesh=torch.zeros(4, 2))
    with pytest.raises(NotImplementedError, match="item 9b"):
        run_inference(TBright(), [], mesh=tp, fastserve=True)
    with pytest.raises(TypeError, match="supports ViTAntiSpoof and "
                       "ViTLinearHead"):
        trunner.make_fastserve_infer(TBright())


def _hf_pth(path, params, depth):
    from test_torch_registry import _hf_from_linear_tree
    torch.save({k: torch.tensor(v) for k, v in
                _hf_from_linear_tree(params, depth).items()}, path)


def test_registry_models_cross_eval_match_jax(tree, tmp_path):
    """Three registry entries at 32x32 on weights carried across as
    files: the published-format .pth, an HF-keyed .pth and a
    torchvision-keyed .pth; SigNet_F (an untrained placeholder on both
    sides) is scored by the port only."""
    x0 = jnp.zeros((1, 32, 32, 3))
    vit_v = jvit.ViTAntiSpoof().init(jax.random.PRNGKey(0), x0)
    ckpt = tmp_path / "best.pth"
    jconvert.save_torch_checkpoint(str(ckpt), vit_v)
    lin = jax.tree.map(np.asarray, jvit.ViTLinearHead().init(
        jax.random.PRNGKey(1), x0))
    hf = tmp_path / "hf.pth"
    _hf_pth(hf, lin["params"], 12)
    rn = jresnet.ResNet50().init(jax.random.PRNGKey(2), x0)
    tv = tmp_path / "tv.pth"
    torch.save({k: torch.tensor(v) for k, v in
                tconvert.resnet50_to_torch(rn).items()}, tv)
    pre = {"Base_ViT_Pretrained": str(hf), "ResNet50_Pretrained": str(tv)}
    jrec, trec = jscan_test(str(tree)), scan_test(str(tree))
    names = ["Custom_ViT_FineTuned", "Base_ViT_Pretrained",
             "ResNet50_Pretrained"]
    jres = jharness.run_cross_model_eval(
        jrec, output_dir=str(tmp_path / "jax"), checkpoint_path=str(ckpt),
        pretrained_paths=pre, model_names=names, batch_size=8, img_size=32)
    tres = run_cross_model_eval(
        trec, output_dir=str(tmp_path / "port"), checkpoint_path=str(ckpt),
        pretrained_paths=pre, model_names=names + ["SigNet_F"],
        batch_size=8, img_size=32, device="cpu")
    assert list(jres) == names and list(tres) == names + ["SigNet_F"]
    for name in names:
        def scores(d):
            with open(tmp_path / d / name / "per_image_predictions.csv") as f:
                return np.array([float(r["spoof_score"])
                                 for r in csv.DictReader(f)])
        np.testing.assert_allclose(scores("port"), scores("jax"), atol=1e-4,
                                   err_msg=name)
        s = json.loads((tmp_path / "port" / name /
                        "evaluation_summary.json").read_text())
        y = 1 - np.array([r.label for r in trec])
        sc = scores("port")
        assert s["roc_auc"] == tparity.np_auc_trapezoid(
            *tparity.np_roc_curve(y, sc)[:2])
    assert (tmp_path / "port" / "SigNet_F" / "evaluation_report.txt").exists()


def test_fastserve_inference_matches_jax_fastserve(tree):
    """``fastserve=True`` (the serving path on the block kernels' plain
    versions here) against JAX's fastserve path in interpret mode on the
    same weights: within 5e-3 (bf16 serving numerics on both sides, the
    bound of tests/test_torch_fastserve.py's scores)."""
    geom = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)
    jm = jvit.ViTAntiSpoof(**geom, gelu="tanh")
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = tconvert.load_jax_params(
        tvit.ViTAntiSpoof(**geom, gelu="tanh", img_size=32),
        jax.tree.map(np.asarray, variables))
    jrec, trec = jscan_test(str(tree)), scan_test(str(tree))
    want = jrun_inference(jm, variables, jrec, batch_size=4, img_size=32,
                          interpret=True, fastserve=True)
    got = run_inference(tm, trec, batch_size=4, img_size=32, fastserve=True)
    np.testing.assert_allclose(got["prob1"], want["prob1"], atol=5e-3)
    np.testing.assert_array_equal(got["pred"], (got["prob1"] > 0.5))
