"""Dependency-free HTTP front end over the MicroBatcher (the port's
counterpart of the JAX package's ``serve/server.py``).

Endpoints (stdlib ``http.server``, one thread per connection; the single
dispatcher thread of the batcher owns the card):

- ``POST /score``: the body is image bytes (anything PIL decodes), or one
  raw pre-decoded ``n*n*3`` uint8 RGB frame with ``Content-Type:
  application/x-pad-raw`` (no host decode).  Response ``{"prob_live": p,
  "pred": 0|1, "label": "live"|"spoof", "latency_ms": t}`` (1 = live).
  Undecodable bodies get HTTP 422.
- ``POST /score-batch``: N concatenated raw frames in one request;
  parallel ``prob_live``/``pred`` arrays back.
- ``GET /healthz``: liveness and the program table's metadata.
- ``GET /stats``: batcher counters and latency percentiles.
- ``GET /metrics``: the same in Prometheus text format 0.0.4.
- ``POST /admin/reload``: rebuild the program table from the server's
  source and swap it in; the new batcher warms before it takes traffic
  and the old one drains its queue.

The program table comes from frozen serving artifacts
(:func:`build_programs_from_artifacts`, ``models/artifact.py``): one
symbolic-batch module artifact serves every batch size, and fixed-batch
kernel artifacts (e.g. lowlat B = 1 and fastserve B = 32) each add their
shape; or from a live model (:func:`build_programs_live`), where each
batch shape gets the regime of ``fastserve.auto_serving_mode`` (B = 1
``lowlat``, 2 ``batch_grid``, >= 3 ``fastserve``, the H100's measured
table).  The
dispatcher picks the smallest shape that fits each window.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

from .batcher import MicroBatcher

log = logging.getLogger(__name__)

_MAX_BODY = 32 * 1024 * 1024          # 32 MB: generous for one image
_MAX_BATCH_FRAMES = 1024              # /score-batch cap (~154 MB at 224²)


def prometheus_text(stats: dict, *, uptime_s: float,
                    prefix: str = "pad") -> str:
    """The batcher's stats dict in Prometheus exposition format (text
    version 0.0.4): counters as ``*_total``, the latency percentiles as a
    quantile-labelled summary.  A pure function of the ``/stats`` payload,
    so both endpoints agree."""
    lines = []

    def metric(name, mtype, help_, value, labels=""):
        lines.append(f"# HELP {prefix}_{name} {help_}")
        lines.append(f"# TYPE {prefix}_{name} {mtype}")
        lines.append(f"{prefix}_{name}{labels} {value}")

    metric("uptime_seconds", "gauge", "Seconds since server start.",
           round(uptime_s, 1))
    for key, help_ in (
            ("requests", "Scored images accepted across endpoints."),
            ("batches", "Device dispatches."),
            ("images", "Image rows dispatched (incl. padding)."),
            ("padded_rows", "Padding rows dispatched (wasted device "
                            "work; 0 under the zero-pad planner)."),
            ("errors", "Requests failed inside the dispatcher.")):
        metric(f"{key}_total", "counter", help_, int(stats.get(key, 0)))
    metric("batch_fill_avg", "gauge",
           "Mean images per device dispatch.",
           round(float(stats.get("avg_batch", 0.0)), 3))
    lat = stats.get("latency_ms")
    if lat:
        name = f"{prefix}_latency_milliseconds"
        lines.append(f"# HELP {name} Submit-to-result latency "
                     "(dispatcher queue + device).")
        lines.append(f"# TYPE {name} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'{name}{{quantile="{q}"}} {lat[key]}')
        lines.append(f"{name}_max {lat['max']}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries .batcher / .metas / .started
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):           # route through logging
        log.debug("%s %s", self.address_string(), fmt % args)

    def _send_json(self, code: int, payload: dict, close: bool = False):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if close:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _reject(self, code: int, payload: dict):
        """Error response on a path that may leave declared body bytes
        unread: close the connection, or a keep-alive client would have
        the leftover bytes parsed as its next request line."""
        self.close_connection = True
        self._send_json(code, payload, close=True)

    def _content_type(self) -> str:
        """Media type, lowercased, MIME parameters stripped."""
        raw = self.headers.get("Content-Type") or ""
        return raw.split(";")[0].strip().lower()

    def _length(self) -> int:
        try:
            return int(self.headers.get("Content-Length", 0))
        except ValueError:
            return 0

    def do_GET(self):                            # noqa: N802 (stdlib API)
        srv = self.server
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "uptime_s": round(time.monotonic() - srv.started, 1),
                "img_size": srv.batcher.img_size,
                "batch_sizes": list(srv.batcher.batch_sizes),
                "artifacts": srv.metas})
        elif self.path == "/stats":
            self._send_json(200, srv.batcher.stats())
        elif self.path == "/metrics":
            body = prometheus_text(
                srv.batcher.stats(),
                uptime_s=time.monotonic() - srv.started).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):                           # noqa: N802 (stdlib API)
        if self.path == "/score-batch":
            self._score_batch()
            return
        if self.path == "/admin/reload":
            self._reload()
            return
        if self.path != "/score":
            self._reject(404, {"error": f"unknown path {self.path}"})
            return
        srv = self.server
        length = self._length()
        if length <= 0:
            self._reject(400, {"error": "empty body (send the image "
                                        "bytes as the request body)"})
            return
        if length > _MAX_BODY:
            self._reject(413, {"error": f"body {length} B exceeds "
                                        f"{_MAX_BODY} B"})
            return
        data = self.rfile.read(length)
        if len(data) != length:
            self._reject(400, {"error": f"truncated body: declared "
                                        f"{length} B, got {len(data)}"})
            return

        t0 = time.monotonic()
        n = srv.batcher.img_size
        if self._content_type() == "application/x-pad-raw":
            if length != n * n * 3:
                self._reject(400, {
                    "error": f"x-pad-raw body must be {n}*{n}*3 = "
                             f"{n * n * 3} bytes, got {length}"})
                return
            image = np.frombuffer(data, np.uint8).reshape(n, n, 3)
        else:
            from ..data.loader import decode_image_bytes
            try:
                image = decode_image_bytes(data, n)
            except ValueError as e:
                self._send_json(422, {"error": str(e)})
                return
        try:
            result = _submit_retry(srv, lambda b: b.submit(image)).result(
                timeout=srv.request_timeout)
        except Exception as e:                   # noqa: BLE001
            self._send_json(500, {"error": f"inference failed: {e}"})
            return
        self._send_json(200, {
            "prob_live": result["prob1"],
            "pred": result["pred"],
            "label": "live" if result["pred"] == 1 else "spoof",
            "latency_ms": round((time.monotonic() - t0) * 1000.0, 3)})

    def _score_batch(self):
        """``POST /score-batch``: the body is N x (n*n*3) raw uint8 RGB
        bytes (``application/x-pad-raw``), N read from the length.  The
        dispatcher packs the frames onto the batch shapes, interleaved
        with ``/score`` traffic; the arrays keep the frames' order."""
        srv = self.server
        if self._content_type() != "application/x-pad-raw":
            self._reject(415, {
                "error": "score-batch takes Content-Type "
                         "application/x-pad-raw (concatenated raw "
                         "uint8 RGB frames)"})
            return
        length = self._length()
        n = srv.batcher.img_size
        frame_bytes = n * n * 3
        if length <= 0 or length % frame_bytes != 0:
            self._reject(400, {
                "error": f"body must be a positive multiple of "
                         f"{n}*{n}*3 = {frame_bytes} bytes, got "
                         f"{length}"})
            return
        count = length // frame_bytes
        if count > _MAX_BATCH_FRAMES:
            self._reject(413, {
                "error": f"{count} frames exceeds the per-request cap "
                         f"of {_MAX_BATCH_FRAMES}; split the block"})
            return
        data = self.rfile.read(length)
        if len(data) != length:
            self._reject(400, {"error": f"truncated body: declared "
                                        f"{length} B, got {len(data)}"})
            return
        t0 = time.monotonic()
        frames = np.frombuffer(data, np.uint8).reshape(count, n, n, 3)
        try:
            futs = _submit_retry(srv, lambda b: b.submit_many(frames))
            deadline = t0 + srv.request_timeout
            results = [f.result(timeout=max(0.0, deadline -
                                            time.monotonic()))
                       for f in futs]
        except Exception as e:                   # noqa: BLE001
            self._send_json(500, {"error": f"inference failed: {e}"})
            return
        self._send_json(200, {
            "prob_live": [r["prob1"] for r in results],
            "pred": [r["pred"] for r in results],
            "count": count,
            "latency_ms": round((time.monotonic() - t0) * 1000.0, 3)})

    def _reload(self):
        """``POST /admin/reload``: rebuild the program table from the
        server's source and swap it in with no downtime: the new
        MicroBatcher warms every shape before the swap, traffic flows on
        the old one meanwhile, and the old dispatcher drains its queue on
        close."""
        srv = self.server
        length = self._length()
        if length > 0:                 # drain the body: keep-alive stays
            self.rfile.read(min(length, _MAX_BODY))    # coherent
        if srv.rebuild is None:
            self._reject(403, {"error": "this server was built "
                                        "without a rebuild source"})
            return
        t0 = time.monotonic()
        if not srv.reload_lock.acquire(blocking=False):
            self._reject(409, {"error": "a reload is already in "
                                        "progress"})
            return
        new_b = None
        try:
            programs, img_size, metas = srv.rebuild()
            if int(img_size) != srv.batcher.img_size:
                self._reject(409, {
                    "error": f"reload changed img_size "
                             f"{srv.batcher.img_size} -> {img_size}; "
                             f"start a new server instance instead"})
                return
            new_b = MicroBatcher(programs, img_size=int(img_size),
                                 max_wait_ms=srv.max_wait_ms)
            new_b.warmup()
            old = srv.batcher
            srv.batcher, srv.metas = new_b, metas
            new_b = None                      # handed over: do not close
            old.close()
        except Exception as e:               # noqa: BLE001
            log.exception("reload failed")
            self._reject(500, {"error": f"reload failed: {e}"})
            return
        finally:
            if new_b is not None:             # failed before the swap:
                new_b.close()                 # release thread + weights
            srv.reload_lock.release()
        self._send_json(200, {
            "reloaded": True,
            "batch_sizes": list(srv.batcher.batch_sizes),
            "artifacts": srv.metas,
            "latency_ms": round((time.monotonic() - t0) * 1000.0, 3)})


def _submit_retry(srv, submit):
    """Submit against the current batcher; if a reload closed it between
    the handler's read and the enqueue, retry once on the replacement."""
    try:
        return submit(srv.batcher)
    except RuntimeError as e:
        if "closed" not in str(e):
            raise
        return submit(srv.batcher)


class PADServer(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog is 5: bursts of fresh
    # connections (every urllib request is one) get reset under load
    request_queue_size = 128

    def __init__(self, addr, batcher: MicroBatcher, metas,
                 request_timeout: float = 60.0, rebuild=None,
                 max_wait_ms: float = 2.0):
        super().__init__(addr, _Handler)
        self.batcher = batcher
        self.metas = metas
        self.request_timeout = request_timeout
        self.rebuild = rebuild          # () -> (programs, img_size, metas)
        self.max_wait_ms = max_wait_ms
        self.reload_lock = threading.Lock()
        self.started = time.monotonic()

    def shutdown_clean(self):
        """Stop the accept loop (running on another thread), close the
        listening socket, and drain the batcher."""
        self.shutdown()
        self.server_close()
        self.batcher.close()


def build_programs_from_artifacts(artifact_dirs: Sequence[str], *,
                                  max_batch: int = 16, device=None):
    """Load artifacts and assemble the MicroBatcher program table (JAX
    :92): ``(programs, img_size, metas)``.  A fixed-batch artifact adds
    exactly its batch size; a symbolic-batch one fans across power-of-two
    buckets ``1, 2, 4, ... <= max_batch``.  When two artifacts claim one
    size the last listed wins (so a kernel artifact can take over a module
    artifact's bucket).  Artifacts load onto the card unless
    ``device="cpu"``."""
    from ..models.artifact import load_serving_artifact

    if not artifact_dirs:
        raise ValueError("need at least one artifact directory")
    programs, metas = {}, []
    img_size = None
    for d in artifact_dirs:
        art = load_serving_artifact(d, device=device)
        metas.append({"path": str(d), **art.meta})
        size = int(art.meta.get("img_size", 224))
        if img_size is None:
            img_size = size
        elif img_size != size:
            raise ValueError(
                f"artifact {d} has img_size {size}; earlier artifacts "
                f"use {img_size} — a server instance serves one size")

        def call(batch, art=art):
            out = art(batch)
            return {"prob1": out["prob1"].float().cpu().numpy(),
                    "pred": out["pred"].cpu().numpy()}

        fixed = art.meta.get("batch_size")
        if fixed is not None:
            programs[int(fixed)] = call
        else:
            b = 1
            while b <= max_batch:
                programs[b] = call      # last listed wins, uniformly
                b *= 2
    return programs, img_size, metas


def build_programs_live(model, *, shapes: Sequence[int] = (1, 2, 4, 8, 16),
                        img_size: int = 224, threshold: float = 0.5,
                        temperature=None, device=None):
    """Program table from a live model for the MicroBatcher:
    ``({batch_size: callable}, img_size, metas)``.

    Each shape gets the regime of ``fastserve.auto_serving_mode``; shapes
    sharing a regime share one serving function.  ``pred`` is
    ``prob > threshold``; ``temperature`` applies ``sigmoid(logit(p) / T)``
    on the host before thresholding.  Runs on the card unless
    ``device="cpu"``."""
    from ..analysis.calibration import apply_temperature
    from ..models.fastserve import auto_serving_mode, make_serving_fn

    threshold = float(threshold)
    if not 0.0 < threshold < 1.0:
        raise ValueError(f"threshold must be in (0, 1), got {threshold}")
    if temperature is not None and float(temperature) <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    sizes = sorted({int(s) for s in shapes})
    per_mode, programs, modes = {}, {}, {}
    for s in sizes:
        mode = auto_serving_mode(s)
        fn = per_mode.get(mode)
        if fn is None:
            fn = per_mode[mode] = make_serving_fn(
                model, batch_size=s, mode=mode, device=device)

        def call(batch, fn=fn):
            prob1 = fn(batch).float().cpu().numpy()
            if temperature is not None:
                prob1 = apply_temperature(prob1, temperature).astype(
                    np.float32)
            return {"prob1": prob1,
                    "pred": (prob1 > threshold).astype(np.int32)}

        programs[s] = call
        modes[s] = mode
    metas = [{"source": "live", "model": type(model).__name__,
              "img_size": int(img_size), "shapes": modes,
              "threshold": threshold, "temperature": temperature}]
    return programs, int(img_size), metas


def make_server_from_programs(programs, img_size, metas, *,
                              host: str = "127.0.0.1", port: int = 8417,
                              max_wait_ms: float = 2.0,
                              request_timeout: float = 60.0,
                              rebuild=None) -> PADServer:
    """Batcher and HTTP server over a program table (not yet serving:
    call ``serve_forever()`` or :func:`run_server`).  ``port=0`` picks a
    free port (``server.server_address[1]``).  ``rebuild`` (optional
    ``() -> (programs, img_size, metas)``) enables ``/admin/reload``."""
    batcher = MicroBatcher(programs, img_size=img_size,
                           max_wait_ms=max_wait_ms)
    return PADServer((host, port), batcher, metas,
                     request_timeout=request_timeout, rebuild=rebuild,
                     max_wait_ms=max_wait_ms)


def make_server(artifact_dirs: Sequence[str], *, host: str = "127.0.0.1",
                port: int = 8417, max_batch: int = 16,
                max_wait_ms: float = 2.0, request_timeout: float = 60.0,
                device=None) -> PADServer:
    """Programs from artifacts, batcher and HTTP server (JAX :473; not
    yet serving).  ``port=0`` picks a free port
    (``server.server_address[1]``); ``/admin/reload`` re-reads the same
    artifact directories."""
    programs, img_size, metas = build_programs_from_artifacts(
        artifact_dirs, max_batch=max_batch, device=device)
    return make_server_from_programs(
        programs, img_size, metas, host=host, port=port,
        max_wait_ms=max_wait_ms, request_timeout=request_timeout,
        rebuild=lambda: build_programs_from_artifacts(
            artifact_dirs, max_batch=max_batch, device=device))


def run_server(server: PADServer, *, warmup: bool = True):
    """Warm every batch shape with a zero batch (so the first request
    does not pay for kernel builds), then block in the accept loop until
    interrupted."""
    b = server.batcher
    if warmup:
        t0 = time.monotonic()
        b.warmup()
        log.info("warmed batch shapes %s in %.1fs", list(b.batch_sizes),
                 time.monotonic() - t0)
    host_, port_ = server.server_address[:2]
    log.info("PAD serving on http://%s:%s (shapes %s, window %.1f ms)",
             host_, port_, list(b.batch_sizes), b._max_wait * 1000)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log.info("interrupt — shutting down")
    finally:
        # serve_forever has returned: shutdown() from this thread would
        # deadlock, and is only needed from others
        server.server_close()
        server.batcher.close()
    return server


def serve(artifact_dirs: Sequence[str], *, host: str = "127.0.0.1",
          port: int = 8417, max_batch: int = 16, max_wait_ms: float = 2.0,
          warmup: bool = True, device=None):
    """Blocking entry point (the ``serve`` verb, artifact flavor)."""
    server = make_server(artifact_dirs, host=host, port=port,
                         max_batch=max_batch, max_wait_ms=max_wait_ms,
                         device=device)
    return run_server(server, warmup=warmup)
