"""`config` command (JAX ``cli/config_cmd.py``): print the RESOLVED
config tree — preset + JSON file + ``--set`` overrides + ``PAD_*`` env
overrides, exactly as every other command would see it; ``--diff``
shows only what deviates from the preset.  For the same argv and
environment it prints the same bytes as the JAX verb.
"""

from __future__ import annotations

import argparse
import json

from .common import add_config_args, resolve_config


def _flatten(tree: dict, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Print the resolved configuration")
    add_config_args(parser)
    parser.add_argument("--diff", action="store_true",
                        help="print only the values that differ from "
                        "the bare preset (i.e. what the file/--set/env "
                        "overrides actually changed)")
    args = parser.parse_args(argv)
    cfg = resolve_config(args)
    if args.diff:
        from ..config import Config
        base = _flatten(Config.preset(args.preset).to_dict())
        resolved = _flatten(cfg.to_dict())
        diff = {k: v for k, v in resolved.items() if base.get(k) != v}
        print(json.dumps(diff, indent=2, default=str))
        return diff
    print(cfg.to_json(default=str))
    return cfg


if __name__ == "__main__":
    main()
