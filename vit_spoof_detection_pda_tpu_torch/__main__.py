"""Dispatcher: ``python -m vit_spoof_detection_pda_tpu_torch <command> ...``

The JAX package's verbs (``vit_spoof_detection_pda_tpu/__main__.py``).
Those whose modules are not ported yet exit with status 2 and name the
ROADMAP item that brings them.
"""

import sys

COMMANDS = {
    "augment": "vit_spoof_detection_pda_tpu_torch.cli.augment",
    "train": "vit_spoof_detection_pda_tpu_torch.cli.train",
    "test": "vit_spoof_detection_pda_tpu_torch.cli.test",
    "evaluate-all": "vit_spoof_detection_pda_tpu_torch.cli.evaluate_all",
    "analyze": None,
    "benchmark": "vit_spoof_detection_pda_tpu_torch.cli.benchmark",
    "export": "vit_spoof_detection_pda_tpu_torch.cli.export",
    "export-serving": "vit_spoof_detection_pda_tpu_torch.cli.export_serving",
    "predict": "vit_spoof_detection_pda_tpu_torch.cli.predict",
    "serve": "vit_spoof_detection_pda_tpu_torch.cli.serve",
    "serve-bench": "vit_spoof_detection_pda_tpu_torch.cli.serve_bench",
    "describe": "vit_spoof_detection_pda_tpu_torch.cli.describe",
    "config": "vit_spoof_detection_pda_tpu_torch.cli.config_cmd",
    "doctor": "vit_spoof_detection_pda_tpu_torch.cli.doctor",
    "demo": None,
}

# the ROADMAP item that brings each verb not ported yet
NOT_PORTED = {
    "analyze": "ROADMAP Queue 1 item 10 (the analysis modules)",
    "demo": "ROADMAP Queue 1 item 10 (it drives analyze, which waits for "
            "item 10)",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m vit_spoof_detection_pda_tpu_torch "
              f"{{{','.join(COMMANDS)}}} [options]")
        print(__doc__)
        return 0 if argv else 1
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; choose from {list(COMMANDS)}")
        return 1
    if COMMANDS[cmd] is None:
        print(f"the {cmd!r} verb is not ported to the PyTorch/CUDA package "
              f"yet: {NOT_PORTED[cmd]}", file=sys.stderr)
        return 2
    import importlib

    mod = importlib.import_module(COMMANDS[cmd])
    mod.main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
