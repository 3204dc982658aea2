"""`serve-bench` command (JAX ``cli/serve_bench.py``): load-test a running
PAD scoring service (``serve/loadgen.py``) from any client host — no
model code, no card.

    python -m vit_spoof_detection_pda_tpu_torch serve-bench \\
        http://10.0.0.5:8417 --clients 32 --requests 1024 --mode raw
    python -m vit_spoof_detection_pda_tpu_torch serve-bench \\
        http://10.0.0.5:8417 --batch 128 --clients 4 --requests 16

Prints one JSON line: throughput, client latency percentiles, error
count, server-side batch fill (from /stats).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Load-test a running PAD scoring service")
    parser.add_argument("url", help="service base URL (http://host:port)")
    parser.add_argument("--mode", default="raw", choices=("raw", "jpeg"),
                        help="body flavor for /score: pre-decoded raw "
                        "frames (device+service cost) or JPEG (full "
                        "ingest incl. server-side decode)")
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--requests", type=int, default=256)
    parser.add_argument("--img-size", type=int, default=224)
    parser.add_argument("--batch", type=int, default=None,
                        help="use /score-batch with N raw frames per "
                        "request (bulk callers)")
    parser.add_argument("--image", default=None,
                        help="POST this file's bytes instead of a "
                        "synthesized frame (/score only)")
    parser.add_argument("--warmup", type=int, default=16)
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args(argv)

    if args.clients < 1:
        parser.error("--clients must be >= 1")
    if args.requests < 1:
        parser.error("--requests must be >= 1")
    if args.batch is not None and args.batch < 1:
        parser.error("--batch must be >= 1")
    if args.batch is not None and args.image is not None:
        parser.error("--image applies to /score; --batch synthesizes "
                     "raw frames")

    from ..serve.loadgen import run_load
    out = run_load(args.url, mode=args.mode, clients=args.clients,
                   requests=args.requests, img_size=args.img_size,
                   batch=args.batch, image_path=args.image,
                   warmup=args.warmup, timeout=args.timeout)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
