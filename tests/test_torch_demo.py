"""The port's ``demo`` verb: the one-command lifecycle on the CPU (the
kernels' plain versions), every stage's artifact checked, and its stages
those of the JAX package's demo, in order.  About 45 s on the CPU."""

import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _stages(path: Path) -> list:
    return re.findall(r'_stage\("([^"]+)"\)', path.read_text())


def test_demo_stages_are_jax_stages():
    port = _stages(ROOT / "vit_spoof_detection_pda_tpu_torch/cli/demo.py")
    jax_ = _stages(ROOT / "vit_spoof_detection_pda_tpu/cli/demo.py")
    assert port == jax_ and len(port) == 11


def test_demo_without_pil_exits_before_any_stage(monkeypatch, tmp_path,
                                                 capsys):
    from vit_spoof_detection_pda_tpu_torch.cli.demo import main

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="PIL"):
        main(["--device", "cpu", "--out", str(tmp_path / "ws")])
    assert "=== demo" not in capsys.readouterr().out
    assert not (tmp_path / "ws").exists()


def test_demo_full_lifecycle_on_the_cpu(tmp_path):
    from vit_spoof_detection_pda_tpu_torch.cli.demo import main

    ws = tmp_path / "ws"
    report = main(["--device", "cpu", "--out", str(ws)])
    for stage in ("data", "augment", "train", "test", "evaluate_all",
                  "analyze", "export_serving", "describe", "predict",
                  "export"):
        assert f"{stage}_s" in report, stage
    assert report["val_f1"] > 0.9 and report["test_auc"] > 0.9
    assert any((ws / "aug" / "live").glob("*.jpg"))
    assert any(p.name.isdigit() for p in (ws / "ckpts").iterdir())
    assert (ws / "results_test").is_dir()
    assert (ws / "results" / "model_comparison.json").exists()
    assert (ws / "results" / "score_distribution_analysis.json").exists()
    assert (ws / "results" / "final_summary.json").exists()
    assert any((ws / "results" / "figures").glob("*.png"))
    assert (ws / "artifact" / "meta.json").exists()
    assert (ws / "artifact" / "serving.pt2").exists()
    assert len((ws / "predictions.csv").read_text().splitlines()) == 17
    assert (ws / "export.pth").exists()
