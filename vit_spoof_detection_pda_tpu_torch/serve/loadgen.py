"""HTTP load generator for the PAD scoring service (the port's copy of
the JAX package's ``serve/loadgen.py``): stdlib HTTP against the server's
endpoints, no model code.

- ``mode="raw"``: pre-decoded ``application/x-pad-raw`` frames on
  ``POST /score`` (service and device cost without host decode);
- ``mode="jpeg"``: encoded bodies on ``POST /score`` (the whole ingest
  path, server-side decode included; PIL is imported only here);
- ``batch=N``: N concatenated raw frames per ``POST /score-batch``.

Reports wall-clock throughput, client-side latency percentiles, error
counts and the server's own ``/stats`` delta (batch fill).
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _post(url: str, path: str, body: bytes, ctype: str, timeout: float):
    req = urllib.request.Request(
        url.rstrip("/") + path, data=body, method="POST",
        headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url: str, path: str, timeout: float):
    with urllib.request.urlopen(url.rstrip("/") + path,
                                timeout=timeout) as r:
        return json.loads(r.read())


def sample_frame(img_size: int) -> np.ndarray:
    """The uint8 RGB frame every generated request carries (a numpy seed,
    so a caller can score it directly and check the answers)."""
    return np.random.default_rng(0).integers(0, 256, (img_size, img_size, 3),
                                             np.uint8)


def _make_body(mode: str, img_size: int, image_path):
    if image_path is not None:
        with open(image_path, "rb") as f:
            return f.read(), "application/octet-stream"
    frame = sample_frame(img_size)
    if mode == "raw":
        return frame.tobytes(), "application/x-pad-raw"
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=90)
    return buf.getvalue(), "application/octet-stream"


def run_load(url: str, *, mode: str = "raw", clients: int = 8,
             requests: int = 256, img_size: int = 224, batch=None,
             image_path=None, warmup: int = 16,
             timeout: float = 300.0, answers=None) -> dict:
    """Drive the service and return a stats dict (see the module doc).

    ``batch=N`` switches to ``/score-batch`` with N raw frames per
    request (``mode`` and ``image_path`` are then ignored: the batch
    endpoint takes raw frames only).  ``answers``, a list, receives every
    response of the measured run (the frame is :func:`sample_frame`)."""
    if mode not in ("raw", "jpeg"):
        raise ValueError(f"mode must be 'raw' or 'jpeg', got {mode!r}")
    if clients < 1 or requests < 1:
        raise ValueError("clients and requests must be >= 1")
    if not url.startswith(("http://", "https://")):
        raise ValueError(f"url needs a scheme (http://host:port), "
                         f"got {url!r}")
    if batch is not None:
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        frame = sample_frame(img_size)
        body = np.broadcast_to(
            frame, (int(batch),) + frame.shape).tobytes()
        ctype, path = "application/x-pad-raw", "/score-batch"
    else:
        body, ctype = _make_body(mode, img_size, image_path)
        path = "/score"

    errors, latencies = [], []

    def one(_):
        t0 = time.monotonic()
        try:
            out = _post(url, path, body, ctype, timeout)
            n = out.get("count", 1)
        except (urllib.error.URLError, urllib.error.HTTPError,
                OSError, ValueError) as e:
            # ValueError: a malformed URL, or a body that is not JSON
            errors.append(repr(e))
            return 0
        latencies.append((time.monotonic() - t0) * 1e3)
        if answers is not None and measured:
            answers.append(out)
        return n

    measured = False
    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(one, range(min(warmup, requests))))
    measured = True
    latencies.clear()
    errors.clear()
    # /stats after the warmup has drained, so the batch-fill delta covers
    # only the measured run
    try:
        stats_before = _get(url, "/stats", timeout)
    except Exception:                            # noqa: BLE001
        stats_before = None
    t0 = time.monotonic()
    with ThreadPoolExecutor(clients) as pool:
        counts = list(pool.map(one, range(requests)))
    wall = time.monotonic() - t0
    n_img = int(sum(counts))

    if batch:
        eff_mode = f"batch{batch}"
    elif image_path is not None:
        eff_mode = "file"      # file bytes always take the decode path
    else:
        eff_mode = mode
    lat = np.asarray(latencies)
    out = {
        "url": url, "endpoint": path, "mode": eff_mode,
        "clients": clients, "requests": requests, "images": n_img,
        "wall_s": round(wall, 3),
        "img_per_s": round(n_img / wall, 1) if wall > 0 else None,
        # None, not 0.0: an all-errors run must not read as 0 ms latency
        "latency_ms": None if not latencies else {
            "p50": round(float(np.percentile(lat, 50)), 3),
            "p95": round(float(np.percentile(lat, 95)), 3),
            "p99": round(float(np.percentile(lat, 99)), 3),
            "mean": round(float(lat.mean()), 3)},
        "errors": len(errors),
        "error_samples": errors[:3],
    }
    try:
        stats_after = _get(url, "/stats", timeout)
        out["server_stats"] = stats_after
        if stats_before:
            d_img = (stats_after.get("images", 0)
                     - stats_before.get("images", 0))
            d_disp = (stats_after.get("batches", 0)
                      - stats_before.get("batches", 0))
            if d_disp > 0:
                out["avg_batch_fill"] = round(d_img / d_disp, 2)
    except Exception:                            # noqa: BLE001
        pass
    return out
