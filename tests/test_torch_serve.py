"""The port's serving runtime: its copy of the MicroBatcher (planner,
coalescing, errors, drain) and ``build_programs_live`` over the port's
serving path on the CPU, held against the direct scores and against the
JAX package's planner and temperature transform."""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.analysis import calibration as jcal
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.serve import MicroBatcher as JaxBatcher
from vit_spoof_detection_pda_tpu_torch.analysis import calibration as tcal
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.serve import (MicroBatcher,
                                                     build_programs_live)

SIZE = 32


def _fake_program(calls=None, fail=False):
    """prob1 = mean pixel / 255 — row-identifying and order-preserving."""
    def program(batch):
        if fail:
            raise RuntimeError("boom")
        if calls is not None:
            calls.append(batch.shape[0])
        p = batch.reshape(batch.shape[0], -1).mean(axis=1) / 255.0
        return {"prob1": p.astype(np.float32),
                "pred": (p >= 0.5).astype(np.int32)}
    return program


def _img(value):
    return np.full((SIZE, SIZE, 3), value, np.uint8)


@pytest.fixture(scope="module")
def model():
    geom = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)
    jm = jvit.ViTAntiSpoof(**geom, gelu="tanh")
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    tm = tvit.ViTAntiSpoof(**geom, gelu="tanh", img_size=SIZE).eval()
    return tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))


@pytest.mark.parametrize("sizes,cases", [
    ((1, 16, 128), {32: (16, 16), 17: (16, 1), 20: (16, 1, 1, 1, 1),
                    128: (128,), 1: (1,), 127: (16,) * 7 + (1,) * 15}),
    ((4, 16), {3: (4,), 7: (4, 4), 12: (4, 4, 4)}),
    ((32, 128), {1: (32,), 33: (32, 32), 100: (128,), 129: (128, 32),
                 300: (128, 128, 32, 32)}),
])
def test_plan_cases_match_the_jax_batcher(sizes, cases):
    p = _fake_program()
    ours = MicroBatcher({s: p for s in sizes}, img_size=SIZE)
    ref = JaxBatcher({s: p for s in sizes}, img_size=SIZE)
    try:
        for b, want in cases.items():
            assert ours._plan(b) == want == ref._plan(b)
        for b in range(1, 300, 7):
            assert ours._plan(b) == ref._plan(b)
    finally:
        ours.close()
        ref.close()


def test_batcher_coalesces_and_fans_out_in_order():
    calls = []
    b = MicroBatcher({1: _fake_program(calls), 4: _fake_program(calls)},
                     img_size=SIZE, max_wait_ms=100.0)
    try:
        vals = list(range(10, 70, 10))        # 6 queued -> plan (4, 1, 1)
        futs = b.submit_many(np.stack([_img(v) for v in vals]))
        outs = [f.result(timeout=5) for f in futs]
        for v, o in zip(vals, outs):
            assert o["prob1"] == pytest.approx(v / 255.0)
        assert sorted(calls) == [1, 1, 4]
        assert b.stats()["padded_rows"] == 0
    finally:
        b.close()


def test_batcher_error_propagates_to_every_request():
    b = MicroBatcher({2: _fake_program(fail=True)}, img_size=SIZE,
                     max_wait_ms=20.0)
    try:
        futs = [b.submit(_img(1)), b.submit(_img(2))]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=5)
        assert b.stats()["errors"] == 2
    finally:
        b.close()


def test_batcher_validates_input_and_drains_on_close():
    gate = threading.Event()

    def slow(batch):
        gate.wait(5)
        return _fake_program()(batch)

    b = MicroBatcher({1: slow}, img_size=SIZE, max_wait_ms=0.0)
    with pytest.raises(ValueError, match="expected uint8"):
        b.submit(np.zeros((SIZE, SIZE, 3), np.float32))
    futs = [b.submit(_img(v)) for v in (5, 6, 7)]
    closer = threading.Thread(target=b.close)
    closer.start()
    gate.set()
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert [f.result(timeout=5)["prob1"] for f in futs] == pytest.approx(
        [5 / 255.0, 6 / 255.0, 7 / 255.0])
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(_img(0))


def test_apply_temperature_matches_jax():
    p = np.random.default_rng(0).random(257)
    for t in (0.5, 1.0, 2.0):
        np.testing.assert_array_equal(tcal.apply_temperature(p, t),
                                      jcal.apply_temperature(p, t))
    with pytest.raises(ValueError, match="temperature"):
        tcal.apply_temperature(p, 0.0)


def test_live_programs_answer_requests_with_the_direct_scores(model):
    programs, img_size, metas = build_programs_live(
        model, shapes=(32, 128), img_size=SIZE, device="cpu")
    assert img_size == SIZE and sorted(programs) == [32, 128]
    assert metas[0]["shapes"] == {32: "fastserve", 128: "fastserve"}
    imgs = np.random.default_rng(1).integers(0, 256, (40, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    direct = tfast.make_serving_fn(model, batch_size=128, device="cpu")(
        imgs).numpy()
    b = MicroBatcher(programs, img_size=SIZE, max_wait_ms=5.0)
    try:
        with ThreadPoolExecutor(6) as pool:
            futs = [pool.submit(lambda i: b.submit(imgs[i]).result(30), i)
                    for i in range(len(imgs))]
            outs = [f.result() for f in futs]
    finally:
        b.close()
    prob1 = np.array([o["prob1"] for o in outs], np.float32)
    # the plain versions compute every row independently of its batch
    np.testing.assert_allclose(prob1, direct, atol=1e-6)
    assert [o["pred"] for o in outs] == [int(p > 0.5) for p in prob1]


def test_live_programs_threshold_and_temperature(model):
    batch = np.stack([_img(40), _img(200)] * 16)
    base = build_programs_live(model, shapes=(32,), img_size=SIZE,
                               device="cpu")[0][32](batch)
    progs, _sz, metas = build_programs_live(
        model, shapes=(32,), img_size=SIZE, device="cpu", threshold=0.9,
        temperature=2.0)
    assert metas[0]["threshold"] == 0.9 and metas[0]["temperature"] == 2.0
    out = progs[32](batch)
    want = tcal.apply_temperature(base["prob1"].astype(np.float64), 2.0)
    np.testing.assert_allclose(out["prob1"], want, atol=1e-6)
    np.testing.assert_array_equal(out["pred"],
                                  (out["prob1"] > 0.9).astype(np.int32))
    assert out["prob1"].dtype == np.float32 and out["pred"].dtype == np.int32
    with pytest.raises(ValueError, match="threshold"):
        build_programs_live(model, shapes=(32,), device="cpu", threshold=1.0)
    with pytest.raises(ValueError, match="temperature"):
        build_programs_live(model, shapes=(32,), device="cpu",
                            temperature=-1.0)


@pytest.fixture(scope="module")
def jax_model():
    geom = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)
    jm = jvit.ViTAntiSpoof(**geom, gelu="tanh")
    return jm, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))


@pytest.mark.parametrize("shapes", [(16, 32), (1, 2, 4, 8, 16)])
def test_live_programs_serve_the_small_batch_regimes(model, jax_model,
                                                      shapes):
    """Each shape runs the port's regime for it (the H100's table,
    ``fastserve.auto_serving_mode``), reported in the metas, and scores as
    JAX ``make_serving_fn(..., mode=<that regime>, interpret=True)`` does
    on the same weights (5e-3: the bf16 score tolerance of
    tests/test_torch_fastserve.py)."""
    from vit_spoof_detection_pda_tpu.models import fastserve as jfast
    from vit_spoof_detection_pda_tpu_torch.models.fastserve import \
        auto_serving_mode

    programs, _sz, metas = build_programs_live(model, shapes=shapes,
                                               img_size=SIZE, device="cpu")
    assert metas[0]["shapes"] == {s: auto_serving_mode(s) for s in shapes}
    assert sorted(programs) == sorted(shapes)
    rng = np.random.default_rng(3)
    for s in (min(shapes), 16):
        batch = rng.integers(0, 256, (s, SIZE, SIZE, 3), dtype=np.uint8)
        got = programs[s](batch)
        want = np.asarray(jfast.make_serving_fn(
            *jax_model, batch_size=s, mode=auto_serving_mode(s),
            interpret=True)(jnp.asarray(batch)), np.float32)
        np.testing.assert_allclose(got["prob1"], want, atol=5e-3)
        assert got["prob1"].dtype == np.float32
        assert got["pred"].dtype == np.int32


def test_build_programs_live_defaults_to_the_jax_shapes(model):
    import inspect

    from vit_spoof_detection_pda_tpu.serve import \
        build_programs_live as jax_build_programs_live

    want = inspect.signature(jax_build_programs_live).parameters["shapes"]
    got = inspect.signature(build_programs_live).parameters["shapes"]
    assert got.default == want.default == (1, 2, 4, 8, 16)
    programs, _sz, metas = build_programs_live(model, img_size=SIZE,
                                               device="cpu")
    assert sorted(programs) == [1, 2, 4, 8, 16]
    # the H100's regime table (fastserve.auto_serving_mode)
    assert metas[0]["shapes"] == {1: "lowlat", 2: "fastserve",
                                  4: "fastserve", 8: "fastserve",
                                  16: "fastserve"}


def test_live_programs_need_a_card_unless_cpu_is_asked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present on this machine")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_programs_live(model, shapes=(32,), img_size=SIZE)
