"""The port's HTTP front (serve/server.py, serve/loadgen.py,
data/loader.py) on 127.0.0.1 over live programs on the CPU: the JAX
package's tests/test_serve.py HTTP cases that need no artifacts, held
against the port's direct scores and the JAX package's pure helpers.

Tolerances: a request dispatched alone runs the B = 1 program, the same
computation as the direct B = 1 score (atol 1e-6); one that may ride a
batch-grid window differs from it only by f32 summation order inside
bf16 roundings, hence 5e-3 (BF16_SCORE_ATOL of
tests/test_torch_fastserve.py).
"""

import http.client
import io
import json
import socket
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_spoof_detection_pda_tpu.data import loader as jloader
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu.serve.server import \
    prometheus_text as jax_prometheus_text
from vit_spoof_detection_pda_tpu_torch.data import loader as tloader
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.serve import (build_programs_live,
                                                     make_server_from_programs,
                                                     prometheus_text,
                                                     run_load)

SIZE = 32
SHAPES = (1, 2, 4)
BF16_SCORE_ATOL = 5e-3
GEOM = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)


def _model(seed):
    jm = jvit.ViTAntiSpoof(**GEOM, gelu="tanh")
    variables = jm.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, SIZE, SIZE, 3)))
    tm = tvit.ViTAntiSpoof(**GEOM, gelu="tanh", img_size=SIZE).eval()
    return tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))


def _img(value):
    return np.full((SIZE, SIZE, 3), value, np.uint8)


def _png(frame):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")     # lossless
    return buf.getvalue()


def _fake_program(value=None):
    """prob1 = mean pixel / 255 (or a constant)."""
    def program(batch):
        p = batch.reshape(batch.shape[0], -1).mean(axis=1) / 255.0
        if value is not None:
            p = np.full_like(p, value)
        return {"prob1": p.astype(np.float32),
                "pred": (p >= 0.5).astype(np.int32)}
    return program


def _start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


def _stop(srv, t):
    srv.shutdown_clean()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(port, path, data, ctype="application/octet-stream"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.headers, r.read()


def _raw(port, frame):
    return _post(port, "/score", frame.tobytes(), "application/x-pad-raw")


@pytest.fixture(scope="module")
def model():
    return _model(0)


@pytest.fixture(scope="module")
def direct(model):
    """The direct B = 1 score of a frame (the lowlat regime)."""
    fn = tfast.make_serving_fn(model, batch_size=1, device="cpu")
    return lambda frame: float(fn(frame[None])[0])


@pytest.fixture(scope="module")
def server(model):
    programs, img_size, metas = build_programs_live(
        model, shapes=SHAPES, img_size=SIZE, device="cpu")
    srv = make_server_from_programs(programs, img_size, metas, port=0,
                                    max_wait_ms=2.0)
    t = _start(srv)
    yield srv
    _stop(srv, t)


def test_raw_score_matches_the_direct_score(server, direct):
    port = server.server_address[1]
    for v in (77, 200):
        status, out = _raw(port, _img(v))
        assert status == 200
        assert out["prob_live"] == pytest.approx(direct(_img(v)), abs=1e-6)
        assert out["pred"] == int(out["prob_live"] > 0.5)
        assert out["label"] == ("live" if out["pred"] == 1 else "spoof")
        assert out["latency_ms"] > 0


def test_encoded_score_and_undecodable_bodies(server, direct):
    port = server.server_address[1]
    frame = np.random.default_rng(1).integers(0, 256, (SIZE, SIZE, 3),
                                              dtype=np.uint8)
    status, out = _post(port, "/score", _png(frame))
    assert status == 200
    assert out["prob_live"] == pytest.approx(direct(frame), abs=1e-6)
    for body, code in ((b"not an image at all", 422), (b"", 400)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/score", body)
        assert ei.value.code == code
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/nope", b"x")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/nope")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:     # wrong raw length
        _post(port, "/score", b"\x00" * 10, "application/x-pad-raw")
    assert ei.value.code == 400


def test_concurrent_requests_agree_with_the_direct_scores(server, direct):
    port = server.server_address[1]
    values = [15, 60, 120, 200, 240, 33, 99, 180]
    with ThreadPoolExecutor(len(values)) as pool:
        outs = list(pool.map(lambda v: _raw(port, _img(v)), values))
    for v, (status, out) in zip(values, outs):
        assert status == 200
        assert out["prob_live"] == pytest.approx(direct(_img(v)),
                                                 abs=BF16_SCORE_ATOL)


def test_score_batch_endpoint(server, direct):
    port = server.server_address[1]
    vals = [15, 85, 170, 240, 33]
    frames = np.stack([_img(v) for v in vals])
    status, out = _post(port, "/score-batch", frames.tobytes(),
                        "application/x-pad-raw")
    assert status == 200 and out["count"] == len(vals)
    want = [direct(f) for f in frames]
    np.testing.assert_allclose(out["prob_live"], want, atol=BF16_SCORE_ATOL)
    assert out["pred"] == [int(p > 0.5) for p in out["prob_live"]]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/score-batch", frames.tobytes())
    assert ei.value.code == 415
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/score-batch", frames.tobytes()[:-7],
              "application/x-pad-raw")
    assert ei.value.code == 400


def test_healthz_stats_and_metrics(server):
    port = server.server_address[1]
    _raw(port, _img(50))
    status, _h, body = _get(port, "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok"
    assert health["img_size"] == SIZE and health["batch_sizes"] == [1, 2, 4]
    meta = health["artifacts"][0]
    assert meta["model"] == "ViTAntiSpoof" and meta["source"] == "live"
    assert meta["shapes"] == {"1": "lowlat", "2": "batch_grid",
                              "4": "fastserve"}
    status, _h, body = _get(port, "/stats")
    stats = json.loads(body)
    assert status == 200 and stats["requests"] >= 1
    assert "latency_ms" in stats and stats["errors"] == 0
    status, headers, body = _get(port, "/metrics")
    text = body.decode()
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    assert "pad_uptime_seconds" in text
    assert 'pad_latency_milliseconds{quantile="0.5"}' in text
    status, _h, body = _get(port, "/stats")
    assert f"pad_requests_total {json.loads(body)['requests']}" in text


def test_prometheus_text_matches_jax():
    stats = {"requests": 7, "batches": 3, "images": 8, "padded_rows": 1,
             "errors": 0, "avg_batch": 8 / 3,
             "latency_ms": {"p50": 1.5, "p95": 2.5, "p99": 3.0,
                            "max": 3.25}}
    empty = {"requests": 0, "batches": 0, "images": 0, "padded_rows": 0,
             "errors": 0, "avg_batch": 0.0}
    for s in (stats, empty):
        assert prometheus_text(s, uptime_s=12.34) == jax_prometheus_text(
            s, uptime_s=12.34)
    text = prometheus_text(stats, uptime_s=12.34)
    assert "pad_batch_fill_avg 2.667" in text
    assert "latency" not in prometheus_text(empty, uptime_s=1.0)


def test_admin_reload_swaps_in_a_live_rebuild(direct):
    m1, m2 = _model(0), _model(9)
    programs, img_size, metas = build_programs_live(
        m1, shapes=(1, 2), img_size=SIZE, device="cpu")
    srv = make_server_from_programs(
        programs, img_size, metas, port=0, max_wait_ms=1.0,
        rebuild=lambda: build_programs_live(m2, shapes=(1, 2),
                                            img_size=SIZE, device="cpu"))
    t = _start(srv)
    try:
        port = srv.server_address[1]
        frame = _img(77)
        s1 = _raw(port, frame)[1]["prob_live"]
        assert s1 == pytest.approx(direct(frame), abs=1e-6)
        status, out = _post(port, "/admin/reload", b"")
        assert status == 200 and out["reloaded"] is True
        assert out["batch_sizes"] == [1, 2]
        s2 = _raw(port, frame)[1]["prob_live"]
        want = float(tfast.make_serving_fn(m2, batch_size=1, device="cpu")(
            frame[None])[0])
        assert s2 == pytest.approx(want, abs=1e-6)
        assert abs(s1 - s2) > 1e-9        # the new weights serve
    finally:
        _stop(srv, t)


def test_admin_reload_without_a_source_is_403():
    srv = make_server_from_programs({1: _fake_program()}, SIZE,
                                    [{"source": "test"}], port=0,
                                    max_wait_ms=1.0)
    t = _start(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.server_address[1], "/admin/reload", b"")
        assert ei.value.code == 403
    finally:
        _stop(srv, t)


def test_failed_reload_keeps_the_old_programs():
    boom = {"on": False}

    def rebuild():
        if boom["on"]:
            raise RuntimeError("bad rebuild")
        return {1: _fake_program()}, SIZE, [{"source": "v2"}]

    srv = make_server_from_programs({1: _fake_program()}, SIZE,
                                    [{"source": "v1"}], port=0,
                                    max_wait_ms=1.0, rebuild=rebuild)
    t = _start(srv)
    try:
        port = srv.server_address[1]
        assert _post(port, "/admin/reload", b"")[1]["reloaded"] is True
        boom["on"] = True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/admin/reload", b"")
        assert ei.value.code == 500
        assert _raw(port, _img(60))[1]["prob_live"] == pytest.approx(
            60 / 255.0)
    finally:
        _stop(srv, t)


def test_error_responses_close_the_keepalive_connection(server):
    port = server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/score-batch", body=b"\xff" * 5000,
                     headers={"Content-Type": "image/jpeg"})
        r = conn.getresponse()
        assert r.status == 415
        assert (r.getheader("Connection") or "").lower() == "close"
        r.read()
    finally:
        conn.close()


def test_content_type_parameters_and_truncated_body(server, direct):
    port = server.server_address[1]
    frame = _img(123)
    status, out = _post(port, "/score", frame.tobytes(),
                        "application/x-pad-raw; charset=binary")
    assert status == 200
    assert out["prob_live"] == pytest.approx(direct(frame), abs=1e-6)
    body = frame.tobytes()[: frame.nbytes // 2]
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        head = (f"POST /score HTTP/1.1\r\nHost: x\r\n"
                f"Content-Type: application/x-pad-raw\r\n"
                f"Content-Length: {frame.nbytes}\r\n\r\n").encode()
        s.sendall(head + body)
        s.shutdown(socket.SHUT_WR)
        resp = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            resp += chunk
        assert b" 400 " in resp.split(b"\r\n", 1)[0]
        assert b"truncated" in resp
    finally:
        s.close()


@pytest.mark.parametrize("kwargs", [{"mode": "raw"}, {"mode": "jpeg"},
                                    {"batch": 3}],
                         ids=["raw", "jpeg", "batch3"])
def test_loadgen_against_the_server(server, kwargs):
    url = f"http://127.0.0.1:{server.server_address[1]}"
    out = run_load(url, clients=4, requests=8, img_size=SIZE, warmup=2,
                   **kwargs)
    assert out["errors"] == 0, out
    assert out["images"] == (24 if kwargs.get("batch") else 8)
    assert out["img_per_s"] > 0 and out["latency_ms"]["p50"] > 0
    assert "server_stats" in out and out["avg_batch_fill"] >= 1


def test_loadgen_answers_are_the_scores_of_its_frame(server, direct):
    """One client: every request is dispatched alone, so every answer is
    the direct B = 1 score of the frame run_load sends."""
    from vit_spoof_detection_pda_tpu_torch.serve.loadgen import sample_frame

    url = f"http://127.0.0.1:{server.server_address[1]}"
    answers = []
    out = run_load(url, clients=1, requests=6, img_size=SIZE, warmup=2,
                   answers=answers)
    assert out["errors"] == 0 and len(answers) == 6
    want = direct(sample_frame(SIZE))
    for a in answers:
        assert a["prob_live"] == pytest.approx(want, abs=1e-6)


def test_loadgen_validates_its_arguments():
    with pytest.raises(ValueError, match="mode"):
        run_load("http://127.0.0.1:1", mode="bmp")
    with pytest.raises(ValueError, match="clients"):
        run_load("http://127.0.0.1:1", clients=0)
    with pytest.raises(ValueError, match="scheme"):
        run_load("127.0.0.1:1")
    with pytest.raises(ValueError, match="batch"):
        run_load("http://127.0.0.1:1", batch=0)


@pytest.mark.parametrize("resize", ["exact", "shorter"])
def test_decode_image_bytes_matches_jax(resize):
    from PIL import Image
    rng = np.random.default_rng(2)
    for shape, fmt in (((40, 56, 3), "PNG"), ((65, 48, 3), "JPEG")):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            buf, format=fmt)
        got = tloader.decode_image_bytes(buf.getvalue(), SIZE, resize)
        want = jloader.decode_image_bytes(buf.getvalue(), SIZE, resize)
        assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="undecodable"):
        tloader.decode_image_bytes(b"garbage", SIZE)
