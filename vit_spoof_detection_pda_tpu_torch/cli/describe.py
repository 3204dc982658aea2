"""`describe` command (JAX ``cli/describe.py``): inspect serving
artifacts, training checkpoints and torch exports WITHOUT loading
programs or weights onto a device.

- serving-artifact directories (``meta.json`` descriptor, the port's and
  the JAX package's alike: both are JSON), with ``--verify`` re-hashing
  the program and weight bytes,
- checkpoint directories: the port's Trainer output (and JAX Orbax
  directories where ``orbax`` imports), a per-step metrics table
  (epoch, val_f1, optimal_threshold, ema_decay, preempted),
- reference-format ``.pth`` exports (epoch / metrics / tensor census),
  read with ``torch.load(weights_only=True)`` and numpy's reconstructors
  allowed (``models/convert.py::load_torch_checkpoint``).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                "uint8": 1, "int32": 4, "int64": 8, "bool": 1,
                "float64": 8}


def _weights_census(spec):
    """(leaf_count, total_bytes) from an artifact's weights_spec, counting
    what it can of a missing or malformed spec."""
    leaves, total = 0, 0
    stack = [spec]
    while stack:
        node = stack.pop()
        if not isinstance(node, dict):
            continue
        kind = node.get("kind")
        if kind == "leaf":
            leaves += 1
            n = 1
            for s in node.get("shape", []):
                n *= int(s)
            total += n * _DTYPE_BYTES.get(node.get("dtype"), 4)
        elif kind == "dict":
            stack.extend(node.get("items", {}).values())
        else:
            items = node.get("items", [])
            stack.extend(items.values() if isinstance(items, dict)
                         else items)
    return leaves, total


def _describe_artifact(path: Path, verify: bool) -> dict:
    """The JAX verb's keys, plus ``torch_version`` (the port's artifacts
    carry it where the JAX package's carry ``jax_version``)."""
    meta = json.loads((path / "meta.json").read_text())
    n_leaves, n_bytes = _weights_census(meta.get("weights_spec", {}))
    out = {
        "kind": "serving_artifact",
        "path": str(path),
        "mode": meta.get("mode"),
        "platforms": meta.get("platforms"),
        "batch_size": meta.get("batch_size", "symbolic"),
        "img_size": meta.get("img_size"),
        "compute_dtype": meta.get("compute_dtype"),
        "threshold": meta.get("threshold", 0.5),
        "temperature": meta.get("temperature"),
        "int8_weights": meta.get("int8_weights", False),
        "model": meta.get("model"),
        "geometry": meta.get("geometry"),
        "mesh": meta.get("mesh"),
        "weight_leaves": n_leaves,
        "weight_bytes": n_bytes,
        "jax_version": meta.get("jax_version"),
        "torch_version": meta.get("torch_version"),
    }
    if verify:
        import hashlib
        ok, missing = True, []
        for fname, want in meta.get("checksums", {}).items():
            try:
                got = hashlib.sha256(
                    (path / fname).read_bytes()).hexdigest()
            except FileNotFoundError:
                # a missing file is a corrupt artifact, not a crash
                ok = False
                missing.append(fname)
                continue
            if got != want:
                ok = False
        out["checksums_ok"] = ok
        if missing:
            out["missing_files"] = missing
    return out


def _describe_checkpoint_dir(path: Path) -> dict:
    from ..utils.checkpoint import _is_orbax_dir, _port_steps, list_checkpoints
    steps = list_checkpoints(str(path))
    orbax = not _port_steps(str(path)) and _is_orbax_dir(str(path))
    return {
        "kind": "orbax_checkpoint" if orbax else "checkpoint_dir",
        "path": str(path),
        "steps": [{"step": s, **m} for s, m in steps],
        "latest_step": steps[-1][0] if steps else None,
    }


def _describe_torch_file(path: Path) -> dict:
    import torch

    from ..models.convert import _numpy_safe_globals
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        obj = torch.load(str(path), map_location="cpu", weights_only=True)
    out = {"kind": "torch_checkpoint", "path": str(path)}
    sd = obj.get("model_state_dict", obj) if isinstance(obj, dict) else obj
    if isinstance(obj, dict) and "model_state_dict" in obj:
        # reference save_checkpoint format (train_advanced.py:475-489)
        out["epoch"] = obj.get("epoch")
        out["metrics"] = obj.get("metrics")
        out["config"] = obj.get("config")
    if hasattr(sd, "items"):
        out["tensors"] = len(sd)
        out["tensor_bytes"] = int(sum(
            t.numel() * t.element_size() for t in sd.values()
            if hasattr(t, "numel")))
    return out


def describe_path(target: str, verify: bool = False) -> dict:
    """``verify`` re-hashes a serving artifact's program and weight
    bytes against its descriptor's checksums."""
    p = Path(target)
    if p.is_dir():
        if (p / "meta.json").exists():
            meta = json.loads((p / "meta.json").read_text())
            if "format_version" in meta:
                return _describe_artifact(p, verify)
        return _describe_checkpoint_dir(p)
    if p.is_file():
        return _describe_torch_file(p)
    raise FileNotFoundError(f"no such checkpoint/artifact: {target}")


def _fmt_bytes(n):
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024


def _print_human(info: dict):
    kind = info["kind"]
    if kind == "serving_artifact":
        b = info["batch_size"]
        print(f"serving artifact  {info['path']}")
        print(f"  mode={info['mode']}  platforms="
              f"{','.join(info['platforms'] or [])}  "
              f"batch={'symbolic' if b is None else b}  "
              f"img={info['img_size']}  dtype={info['compute_dtype']}")
        line = f"  threshold={info['threshold']}"
        if info.get("temperature") is not None:
            line += f"  temperature={info['temperature']}"
        if info.get("int8_weights"):
            line += "  int8-weights"
        print(line)
        print(f"  model={info['model']}  weights={info['weight_leaves']} "
              f"leaves / {_fmt_bytes(info['weight_bytes'])}")
        if info.get("mesh"):
            print(f"  fleet mesh: {info['mesh']}")
        if "checksums_ok" in info:
            print(f"  checksums: {'OK' if info['checksums_ok'] else 'CORRUPT'}")
    elif kind in ("orbax_checkpoint", "checkpoint_dir"):
        print(f"{kind.replace('_', ' ')}  {info['path']}  "
              f"(latest step {info['latest_step']})")
        for row in info["steps"]:
            extras = "  ".join(
                f"{k}={row[k]:.4g}" if isinstance(row[k], float)
                else f"{k}={row[k]}"
                for k in ("epoch", "val_f1", "optimal_threshold",
                          "ema_decay", "preempted") if k in row)
            print(f"  step {row['step']:>8}  {extras}")
    else:
        print(f"torch checkpoint  {info['path']}")
        if "epoch" in info:
            print(f"  epoch={info['epoch']}  metrics={info.get('metrics')}")
        if "tensors" in info:
            print(f"  {info['tensors']} tensors / "
                  f"{_fmt_bytes(info['tensor_bytes'])}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Inspect checkpoints / serving artifacts / torch "
                    "exports (no device, no program load)")
    parser.add_argument("targets", nargs="+",
                        help="artifact dirs, checkpoint directories "
                        "and/or .pth files")
    parser.add_argument("--verify", action="store_true",
                        help="re-hash artifact program/weight bytes "
                        "against the descriptor checksums")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output (one JSON object "
                        "per line)")
    args = parser.parse_args(argv)

    results = []
    for target in args.targets:
        if not os.path.exists(target):
            parser.error(f"no such checkpoint/artifact: {target}")
        info = describe_path(target, verify=args.verify)
        results.append(info)
        if args.json:
            print(json.dumps(info, default=str))
        else:
            _print_human(info)
    return results


if __name__ == "__main__":
    main()
