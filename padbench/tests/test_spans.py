"""The program's spans in a traced stretch (``spans.py``), on a small
synthetic Chrome trace whose answers are worked out by hand: device time
by the launch's correlation (a launch on a second thread inside the main
thread's span included), idle time by the innermost span, the sum of the
idle shares; the existing summary and readers unchanged beside the
``program`` key; the readers' None where no ``vsd.`` span is; and one
tiny traced training run on the CPU through the real profiler."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from padbench import readers, spans, trace
from padbench.harness import Manifest, WINDOW_SPAN
from padbench.tests import tiny

MAIN, ENGINE, SIDE = 1, 2, 3


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


# times in microseconds: the window [0, 1000]; the device busy over
# [60, 90], [210, 260], [320, 340], [350, 360] and [400, 500]
EVENTS = [
    _x("user_annotation", "padbench.window", 0, 1000),
    _x("user_annotation", "padbench.step", 1, 998),
    _x("user_annotation", "vsd.train.forward", 100, 200),
    _x("user_annotation", "vsd.test.inner", 150, 50),
    _x("user_annotation", "vsd.train.backward", 300, 300),
    _x("user_annotation", "vsd.train.update", 900, 200),
    _x("user_annotation", "vsd.test.side", 320, 10, SIDE),
    _x("cpu_op", "aten::mm", 155, 10),
    _x("python_function", "step.py(1): step", 0, 1000),
    _launch(50, 3),                      # no span open anywhere
    _launch(160, 5),                     # inside vsd.test.inner
    _x("cuda_runtime", "cudaMemcpyAsync", 318, 2, MAIN, 9),
    _launch(325, 13, SIDE),              # vsd.test.side on its own thread
    _launch(350, 7, ENGINE),             # no span on the engine thread
    _x("kernel", "k_outside", 60, 30, 7, 3),
    _x("kernel", "k_inner", 210, 50, 7, 5),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 320, 20, 7, 9),
    _x("kernel", "k_side", 350, 10, 7, 13),
    _x("kernel", "k_engine", 400, 100, 7, 7),
    _x("kernel", "k_late", 1000, 50, 7, 99),   # starts after the window
]
EVENTS[16]["args"]["bytes"] = 4096

SUMMARY = {
    "window_s": 1000e-6, "busy_s": 210e-6, "idle_s": 790e-6,
    "kernels": {"k_outside": [30e-6, 1], "k_inner": [50e-6, 1],
                "k_side": [10e-6, 1], "k_engine": [100e-6, 1]},
    "memcpy": [("Memcpy HtoD (Pageable -> Device)", 4096, 20e-6)],
    "spans": {"padbench.window": 1, "padbench.step": 1},
    "device_ops": [["k_engine", 100e-6], ["k_inner", 50e-6],
                   ["k_outside", 30e-6],
                   ["Memcpy HtoD (Pageable -> Device)", 20e-6],
                   ["k_side", 10e-6]],
    "idle_gaps": [["padbench.step/vsd.train.backward", 500e-6],
                  ["padbench.step/-", 120e-6],
                  ["padbench.window/-", 60e-6],
                  ["padbench.step/vsd.train.forward", 60e-6],
                  ["padbench.step/vsd.train.backward", 40e-6],
                  ["padbench.step/vsd.train.backward", 10e-6]],
}
PROGRAM = {   # {span: (n, host, device, idle)} in microseconds
    "-": (0, 0, 30, 370),
    "vsd.train.forward": (1, 200, 0, 100),
    "vsd.test.inner": (1, 50, 50, 50),
    "vsd.train.backward": (1, 300, 120, 170),
    "vsd.test.side": (1, 10, 10, 0),
    "vsd.train.update": (1, 100, 0, 100),
}


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-15)
    else:
        assert got == want


def test_program_spans_by_hand():
    got = spans.summarize(EVENTS, window=WINDOW_SPAN)
    want = {k: {"n": n, "host_s": h * 1e-6, "device_s": d * 1e-6,
                "idle_s": i * 1e-6} for k, (n, h, d, i) in PROGRAM.items()}
    _close(got, want)


def test_idle_shares_sum_to_the_stretch_idle():
    s = trace.summarize(EVENTS, window=WINDOW_SPAN)
    got = spans.summarize(EVENTS, window=WINDOW_SPAN)
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(
        s["idle_s"], rel=1e-12)
    assert spans.summarize(EVENTS, window="padbench.other") is None


def test_the_existing_summary_and_readers_are_unchanged():
    """The summary's keys against a frozen expectation; every existing
    reader the same with and without the ``program`` key beside them."""
    s = trace.summarize(EVENTS, window=WINDOW_SPAN)
    _close(s, SUMMARY)
    cfg = {"peak_flops": 1e12, "dtype": "bfloat16"}
    bare = SimpleNamespace(summary=s, config=cfg, calls={})
    both = SimpleNamespace(summary=dict(s, program=spans.summarize(
        EVENTS, window=WINDOW_SPAN)), config=cfg, calls={})
    calls = [
        lambda c: readers.idle_pct(c),
        lambda c: readers.units(c, "step"),
        lambda c: readers.stretch_mfu(c, "step", 1e6),
        lambda c: readers.h2d_ms(c, "step"),
        lambda c: readers.kernels_ms(c, "k_", "step"),
    ]
    want = [79.0, 1, 0.1, 0.02, 0.19]
    for fn, w in zip(calls, want):
        assert fn(bare) == pytest.approx(w, rel=1e-9)
        assert fn(both) == fn(bare)


def test_span_readers_by_hand():
    s = trace.summarize(EVENTS, window=WINDOW_SPAN)
    ctx = SimpleNamespace(summary=dict(s, program=spans.summarize(
        EVENTS, window=WINDOW_SPAN)))
    assert spans.span_idle_pct(ctx, ["vsd.train.backward"]) == \
        pytest.approx(17.0)
    assert spans.span_idle_pct(ctx, ["vsd.train.forward", "-"]) == \
        pytest.approx(47.0)
    assert spans.span_device_ms(ctx, ["vsd.train.backward"], "step") == \
        pytest.approx(0.12)
    total = sum(spans.span_idle_pct(ctx, [k]) for k in PROGRAM)
    assert total == pytest.approx(readers.idle_pct(ctx))


def test_span_readers_give_none_without_program_spans(monkeypatch):
    s = trace.summarize(EVENTS, window=WINDOW_SPAN)
    parent = SimpleNamespace(summary=s)           # no "program" key
    none_open = SimpleNamespace(summary=dict(s, program={"-": {
        "n": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 790e-6}}))
    for ctx in (parent, none_open, SimpleNamespace(summary=None)):
        for part in ("input", "forward", "backward", "update"):
            assert spans.span_idle_pct(ctx, [f"vsd.train.{part}"]) is None
        assert spans.span_idle_pct(
            ctx, ["vsd.eval.upload", "vsd.eval.collect"]) is None
        assert spans.span_device_ms(ctx, ["vsd.train.update"], "step") \
            is None
        assert spans.span_device_ms(ctx, ["vsd.serve.stem"], "batch") \
            is None
    assert spans.span_total_s("vsd.no.such.span.") is None
    from vit_spoof_detection_pda_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_totals")
    assert spans.span_total_s("vsd.") is None
    m = Manifest(tiny.REPO)
    for name in ("kernel_load_s", "program_build_s"):
        assert m.reader(name).read(None) is None


def test_span_total_s_counts_each_second_once():
    from vit_spoof_detection_pda_tpu_torch.utils.profiling import annotate
    with annotate("vsd.testbuild.outer"):
        time.sleep(0.003)
        with annotate("vsd.testload.inner"):
            time.sleep(0.003)
    build = spans.span_total_s("vsd.testbuild.")
    load = spans.span_total_s("vsd.testload.")
    assert load >= 0.003 and build >= 0.003
    from vit_spoof_detection_pda_tpu_torch.utils.profiling import span_totals
    outer = span_totals()["vsd.testbuild.outer"]["host_s"]
    assert build + load == pytest.approx(outer, rel=1e-9)


def test_a_traced_tiny_training_run_on_the_cpu(tmp_path):
    """The real profiler's Chrome trace of three tiny training steps on
    the CPU, inside the benchmark's window and step spans: the four step
    spans are in the stretch once a step, and the stretch's idle time
    (all of it, with no device) goes to them and sums to its idle."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
    from vit_spoof_detection_pda_tpu_torch.models.fasttrain import make_apply
    from vit_spoof_detection_pda_tpu_torch.ops import losses
    from vit_spoof_detection_pda_tpu_torch.train import state, step
    model = tvit.ViTAntiSpoof(patch_size=16, embed_dim=64, depth=2,
                              num_heads=2, hidden=16, img_size=32,
                              dropout=0.0)
    st = state.create_train_state(
        model, state.make_optimizer(1e-3), device="cpu",
        apply_fn=make_apply(model, dtype=torch.float32))
    train_step = step.make_train_step(losses.make_loss_fn("focal"))
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "label": np.array([0, 1, 1, 0], np.int32)}
    st, _ = train_step(st, batch)                  # warmed, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(3):
                with record_function("padbench.step"):
                    st, _ = train_step(st, batch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = trace.load(path)
    summary = trace.summarize(events, window=WINDOW_SPAN)
    prog = spans.summarize(events, window=WINDOW_SPAN)
    for part in ("input", "forward", "backward", "update"):
        assert prog[f"vsd.train.{part}"]["n"] == 3
    assert summary["busy_s"] == 0 and summary["idle_s"] > 0
    assert sum(v["idle_s"] for v in prog.values()) == pytest.approx(
        summary["idle_s"], rel=1e-9)
    ctx = SimpleNamespace(summary=dict(summary, program=prog))
    shares = [spans.span_idle_pct(ctx, [f"vsd.train.{p}"]) for p in
              ("input", "forward", "backward", "update")]
    outside = spans.span_idle_pct(ctx, [spans.OUTSIDE]) or 0.0
    assert sum(shares) + outside == pytest.approx(100.0, rel=1e-9)
