"""The port's spans (``utils/profiling.py::annotate``): the in-memory
totals (count, host and self seconds; threads), the ``record_function``
that a span opens only under the profiler, the no-op while a program is
exported, the spans the train step, the eval runner, the serving stem
and the set-up open, and the micro-batcher's queue wait.  Span names
here are unique to each test, so no test reads another's totals."""

import ctypes
import json
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu_torch.eval import runner
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.models.fasttrain import make_apply
from vit_spoof_detection_pda_tpu_torch.ops import _build
from vit_spoof_detection_pda_tpu_torch.ops import losses as tl
from vit_spoof_detection_pda_tpu_torch.serve import MicroBatcher
from vit_spoof_detection_pda_tpu_torch.train import state as S
from vit_spoof_detection_pda_tpu_torch.train import step as ST
from vit_spoof_detection_pda_tpu_torch.utils import profiling
from vit_spoof_detection_pda_tpu_torch.utils.profiling import (annotate,
                                                                span_totals)

SIZE = 32
GEOM = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)


def _count(name) -> int:
    return span_totals().get(name, {}).get("count", 0)


def _recorder(monkeypatch, module):
    """Record the names of the spans ``module`` opens, in order."""
    names = []

    def recording(name, args=None):
        names.append(name)
        return annotate(name, args)

    monkeypatch.setattr(module, "annotate", recording)
    return names


def test_span_totals_count_and_nest_into_self_time():
    for _ in range(3):
        with annotate("vsd.test.outer"):
            time.sleep(0.002)
            with annotate("vsd.test.inner"):
                time.sleep(0.004)
    t = span_totals()
    outer, inner = t["vsd.test.outer"], t["vsd.test.inner"]
    assert outer["count"] == inner["count"] == 3
    assert inner["host_s"] >= 0.012 and inner["self_s"] == inner["host_s"]
    assert outer["host_s"] > inner["host_s"]
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], rel=1e-9, abs=1e-12)
    assert outer["self_s"] >= 0.006


def test_span_totals_reset():
    with annotate("vsd.test.reset"):
        pass
    assert span_totals(reset=True)["vsd.test.reset"]["count"] == 1
    assert "vsd.test.reset" not in span_totals()


def test_span_totals_survive_threads():
    """More threads than cores, each nesting spans under a short switch
    interval: no update is lost, and each thread's children count
    against its own parent only."""
    threads_n, reps = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(reps):
                with annotate("vsd.test.thread.outer"):
                    with annotate("vsd.test.thread.inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    t = span_totals()
    outer, inner = t["vsd.test.thread.outer"], t["vsd.test.thread.inner"]
    assert outer["count"] == inner["count"] == threads_n * reps
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], rel=1e-9, abs=1e-12)
    assert outer["self_s"] >= 0


def test_spans_reach_the_profiler_trace_only_while_it_records(
        tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("vsd.test.traced", "lib"):
            torch.ones(8) @ torch.ones(8)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    hits = [e for e in events if e.get("name") == "vsd.test.traced"]
    assert hits and all(e["cat"] == "user_annotation" for e in hits)
    assert _count("vsd.test.traced") == 1

    def refuse(*a, **kw):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with annotate("vsd.test.untraced"):
        torch.ones(8) @ torch.ones(8)
    assert _count("vsd.test.untraced") == 1


def test_a_span_is_a_no_op_while_exporting():
    class Stem(torch.nn.Module):
        def forward(self, x):
            with annotate("vsd.test.exported"):
                return x * 2 + 1

    exported = torch.export.export(Stem(), (torch.ones(3),))
    assert "profiler" not in str(exported.graph_module.code)
    assert _count("vsd.test.exported") == 0
    torch.testing.assert_close(exported.module()(torch.ones(3)),
                               torch.full((3,), 3.0))
    with annotate("vsd.test.exported"):
        pass
    assert _count("vsd.test.exported") == 1


def test_train_step_opens_its_four_spans_in_order(monkeypatch):
    names = _recorder(monkeypatch, ST)
    build_state, build_apply = (_count("vsd.build.train_state"),
                                _count("vsd.build.train_apply"))
    tm = tvit.ViTAntiSpoof(**GEOM, img_size=SIZE, dropout=0.0)
    st = S.create_train_state(tm, S.make_optimizer(1e-3), device="cpu",
                              apply_fn=make_apply(tm, dtype=torch.float32))
    assert _count("vsd.build.train_state") == build_state + 1
    assert _count("vsd.build.train_apply") == build_apply + 1
    before = {n: _count(n) for n in ("vsd.train.input", "vsd.train.update")}
    step = ST.make_train_step(tl.make_loss_fn("focal"))
    rng = np.random.default_rng(0)
    for _ in range(2):
        st, _ = step(st, {"image": rng.standard_normal(
            (4, SIZE, SIZE, 3)).astype(np.float32),
            "label": np.array([0, 1, 1, 0], np.int32)})
    assert names == ["vsd.train.input", "vsd.train.forward",
                     "vsd.train.backward", "vsd.train.update"] * 2
    assert {n: _count(n) - c for n, c in before.items()} == {
        "vsd.train.input": 2, "vsd.train.update": 2}


def test_score_batches_opens_upload_forward_and_collect_once_per_batch(
        monkeypatch):
    names = _recorder(monkeypatch, runner)

    def infer(x):
        v = x[:, 0, 0, 0].float()
        return {"prob1": v, "pred": (v > 100).int()}

    imgs = np.arange(7, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.uint8)
    batches = [{"image": imgs[i:i + 3], "index": np.arange(i, min(i + 3, 7))}
               for i in range(0, 7, 3)]
    prob1, _ = runner.score_batches(infer, batches, 7, batch_size=3,
                                    device="cpu")
    np.testing.assert_array_equal(prob1, np.arange(7, dtype=np.float32))
    up, fw, co = "vsd.eval.upload", "vsd.eval.forward", "vsd.eval.collect"
    assert names == [up, fw, up, fw, co, up, fw, co, co]


def test_cpu_serving_forward_opens_the_stem_span():
    tm = tvit.ViTAntiSpoof(**GEOM, gelu="tanh", img_size=SIZE).eval()
    build, stem = _count("vsd.build.serving"), _count("vsd.serve.stem")
    infer = runner.make_fastserve_infer(tm)
    assert _count("vsd.build.serving") == build + 1
    out = infer(np.zeros((3, SIZE, SIZE, 3), np.uint8))
    assert out["prob1"].shape == (3,)
    assert _count("vsd.serve.stem") == stem + 1


def test_a_kernel_library_opens_the_load_span_on_its_first_load_only(
        monkeypatch):
    lib = SimpleNamespace(vsd_error_string=SimpleNamespace(),
                          vsd_core_launches=SimpleNamespace())
    monkeypatch.setattr(_build, "build", lambda names: [])
    monkeypatch.setattr(ctypes, "CDLL", lambda path: lib)
    monkeypatch.delitem(_build._libs, "vsd_test_lib", raising=False)
    names = _recorder(monkeypatch, _build)
    try:
        assert _build.load("vsd_test_lib") is lib
        assert _build.load("vsd_test_lib") is lib
    finally:
        _build._libs.pop("vsd_test_lib", None)
    assert names == ["vsd.kernels.load"]


def _fake_program(batch):
    p = batch.reshape(batch.shape[0], -1).mean(axis=1) / 255.0
    return {"prob1": p.astype(np.float32), "pred": (p >= 0.5).astype(np.int32)}


def test_batcher_reports_queue_wait_under_latency():
    b = MicroBatcher({1: _fake_program, 4: _fake_program}, img_size=SIZE,
                     max_wait_ms=5.0)
    try:
        assert "queue_wait_ms" not in b.stats()
        futs = b.submit_many(np.zeros((9, SIZE, SIZE, 3), np.uint8))
        for f in futs:
            f.result(timeout=10)
        stats = b.stats()
    finally:
        b.close()
    wait, lat = stats["queue_wait_ms"], stats["latency_ms"]
    assert set(wait) == {"p50", "p95", "p99", "max"}
    for k in wait:
        assert 0.0 <= wait[k] <= lat[k]


def test_the_span_names_of_the_port_start_with_vsd():
    """Every span the port opens is named ``vsd.*``; none takes the
    benchmark's ``padbench.`` prefix."""
    import re
    from pathlib import Path
    root = Path(profiling.__file__).resolve().parents[1]
    names = set()
    for path in root.rglob("*.py"):
        names |= set(re.findall(r'annotate\(\s*"([\w.]+)"', path.read_text()))
    assert names and all(n.startswith("vsd.") for n in names), names
    assert {"vsd.train.input", "vsd.train.forward", "vsd.train.backward",
            "vsd.train.update", "vsd.eval.upload", "vsd.eval.forward",
            "vsd.eval.collect", "vsd.serve.stem",
            "vsd.kernels.load", "vsd.build.serving", "vsd.build.train_state",
            "vsd.build.train_apply"} == names
