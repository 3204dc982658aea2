"""The manifest and the files it names: every cell, configuration,
traffic mix, driver and metric is found by name, names keep to the
allowed characters, and a new configuration, cell or metric needs only
new files and new entries."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

import time

import torch

from padbench.harness import Manifest, run_cell
from padbench.tests.tiny import REPO, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest(REPO)


def test_keys_and_limits(manifest):
    b = manifest.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["padbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_names_and_units(manifest):
    b = manifest.bench
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
             + [w[k] for w in b["workloads"] for k in ("config", "traffic")]
             + [k for c in b["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        assert "\t" not in w["why"] and "\n" not in w["why"]


def test_everything_found_by_name(manifest):
    for cell, entry in manifest.cells.items():
        assert entry["config"] in manifest.configs
        manifest.config(entry["config"])
        manifest.traffic(entry["traffic"])
        wl = manifest.workload(cell)
        assert hasattr(manifest.driver(wl["driver"]), "run")
    for m in manifest.bench["per_layer"]:
        assert hasattr(manifest.reader(m["name"]), "read")
    for c in manifest.bench["configs"]:
        assert c["file"].startswith("padbench/")
        assert manifest.config(c["name"])["reduced"] == c["reduced"]
    used = {w["config"] for w in manifest.bench["workloads"]}
    assert used == set(manifest.configs)


def test_every_cell_reports_what_its_layer_metrics_move(manifest):
    for cell in manifest.cells:
        e2e = {m["name"] for m in manifest.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = manifest.per_layer(cell)
        assert layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in manifest.bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in manifest.bench["end_to_end"]}
        for cell in m.get("workloads", []):
            assert cell in manifest.cells


def test_layers_are_named_as_in_perf_md(manifest):
    perf = (REPO / "PERF.md").read_text()
    for m in manifest.bench["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_new_config_cell_and_metric_are_new_files_only(tmp_path, manifest):
    """A dummy configuration, traffic mix, cell and metric, added as new
    files beside copies of the existing ones and as new entries, load by
    name; no existing file changes."""
    shutil.copytree(REPO / "padbench", tmp_path / "padbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "padbench").rglob("*")
              if p.is_file()}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    d = tmp_path / "padbench"
    cfg = manifest.config("vit_b16_mlp_head")
    cfg.update(TINY, name="dummy_cfg")
    (d / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (d / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "closed", "batch": 4, "pool_batches": 2}))
    (d / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"driver": "score", "entry": "fastserve", "metric": "score_img_per_s",
         "control": "fp8_e4m3",
         "limits": {"margin_max": 1, "margin_spread": 1}}))
    (d / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench["configs"].append({"name": "dummy_cfg", "source": "x",
                             "file": "padbench/configs/dummy_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("dummy.cell")
    bench["per_layer"].append({"name": "dummy_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "Kernels", "moves": "score_img_per_s",
                               "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    m = Manifest(tmp_path)
    assert m.config("dummy_cfg")["num_hidden_layers"] == 2
    assert m.traffic("dummy_mix")["batch"] == 4
    assert m.workload("dummy.cell")["driver"] == "score"
    assert m.reader("dummy_metric").read(None) == 1.0
    assert "dummy_metric" in {x["name"] for x in m.per_layer("dummy.cell")}
    assert {x["name"] for x in m.end_to_end("dummy.cell")} == {
        "score_img_per_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p
    r = run_cell(m, "dummy.cell", seed=2 ** 40 + 1, seconds=0.2, trace=False,
                 device=torch.device("cpu"), t_start=time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"score_img_per_s",
                                                  "setup_s"}
