"""Run one benchmark cell once and print its result as the last line of
standard output.

    python3 padbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch inside the window.  Every
number compared to decide ``correct`` is printed with its limit as the
last lines of standard error and under ``checks``, the result's last
key.  The run needs as many CUDA cards as the cell asks for, and exits
with a non-zero code and no result without them, or when JAX or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_spoof_detection_pda_tpu")


def _environment():
    """Caches inside the checkout at fixed paths; no JAX through a
    library that would load it by itself."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from padbench.harness import Manifest, log, run_cell

    manifest = Manifest(ROOT)
    if args.workload not in manifest.cells:
        log(f"unknown workload {args.workload!r}")
        return 2
    import torch
    need = int(manifest.cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(manifest, args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda"), t_start=T_START)
    result.pop("_readings", None)
    bad = forbidden_modules()
    if bad:
        log(f"loaded after the window: {', '.join(bad)}")
        return 4
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        log(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
