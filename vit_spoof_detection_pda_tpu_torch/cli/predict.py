"""`predict` command (JAX ``cli/predict.py``): score images with a frozen
serving artifact (``models/artifact.py``), the consumer half of
`export-serving`.

Unlike `test` (which rebuilds the model from config and checkpoint), this
path needs no model geometry, weights format or transform knowledge: the
artifact carries the program, the weights and the score convention.
Output is a CSV of ``path,prob_live,pred`` (1 = live).  Runs on the card
unless ``--device cpu`` (a kernel-mode artifact then runs the kernels'
plain versions)."""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

from .common import resolve_device, setup_logging

_EXTS = (".png", ".jpg", ".jpeg")


def _collect_paths(inputs):
    paths = []
    for inp in inputs:
        p = Path(inp)
        if p.is_dir():
            paths.extend(sorted(
                q for q in p.rglob("*") if q.suffix.lower() in _EXTS))
        elif p.is_file():
            paths.append(p)
        else:
            raise FileNotFoundError(f"no such image or directory: {p}")
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Score images with a frozen serving artifact")
    parser.add_argument("artifact", help="artifact dir (export-serving)")
    parser.add_argument("inputs", nargs="+",
                        help="image files and/or directories (recursive)")
    parser.add_argument("--output", default=None,
                        help="CSV destination (default: stdout)")
    parser.add_argument("--batch-size", type=int, default=64,
                        help="decode batch for symbolic-batch artifacts "
                        "(fixed-batch artifacts pin their own)")
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the program runs: the CUDA card (the "
                             "default), or the CPU on the kernels' plain "
                             "PyTorch versions")
    args = parser.parse_args(argv)
    setup_logging()

    paths = _collect_paths(args.inputs)
    if not paths:
        parser.error("no images found under the given inputs")
    device = resolve_device(parser, args)

    from ..data.manifest import Record
    from ..models.artifact import load_serving_artifact, score_records

    artifact = load_serving_artifact(args.artifact, device=device)
    records = [Record(path=str(p), label=-1, name=p.name) for p in paths]
    out = score_records(artifact, records, batch_size=args.batch_size,
                        num_workers=args.num_workers)

    rows = [(str(p), float(s), int(d))
            for p, s, d in zip(paths, out["prob1"], out["pred"])]
    fh = open(args.output, "w", newline="") if args.output else sys.stdout
    try:
        w = csv.writer(fh)
        w.writerow(["path", "prob_live", "pred"])
        w.writerows(rows)
    finally:
        if args.output:
            fh.close()
    live = sum(r[2] for r in rows)
    print(f"scored {len(rows)} images ({live} live / "
          f"{len(rows) - live} spoof at {artifact.threshold}) "
          f"[{artifact.meta['mode']} artifact]", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
