"""Dispatcher: ``python -m vit_spoof_detection_pda_tpu_torch <command> ...``

The JAX package's verbs (``vit_spoof_detection_pda_tpu/__main__.py``),
every one ported.  ``train`` and ``test`` also run under
``torchrun --nproc-per-node N -m vit_spoof_detection_pda_tpu_torch ...``,
one rank per process on the mesh the config's ``sharding.*`` describes.
"""

import sys

COMMANDS = {
    "augment": "vit_spoof_detection_pda_tpu_torch.cli.augment",
    "train": "vit_spoof_detection_pda_tpu_torch.cli.train",
    "test": "vit_spoof_detection_pda_tpu_torch.cli.test",
    "evaluate-all": "vit_spoof_detection_pda_tpu_torch.cli.evaluate_all",
    "analyze": "vit_spoof_detection_pda_tpu_torch.cli.analyze",
    "benchmark": "vit_spoof_detection_pda_tpu_torch.cli.benchmark",
    "export": "vit_spoof_detection_pda_tpu_torch.cli.export",
    "export-serving": "vit_spoof_detection_pda_tpu_torch.cli.export_serving",
    "predict": "vit_spoof_detection_pda_tpu_torch.cli.predict",
    "serve": "vit_spoof_detection_pda_tpu_torch.cli.serve",
    "serve-bench": "vit_spoof_detection_pda_tpu_torch.cli.serve_bench",
    "describe": "vit_spoof_detection_pda_tpu_torch.cli.describe",
    "config": "vit_spoof_detection_pda_tpu_torch.cli.config_cmd",
    "doctor": "vit_spoof_detection_pda_tpu_torch.cli.doctor",
    "demo": "vit_spoof_detection_pda_tpu_torch.cli.demo",
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
    import importlib

    mod = importlib.import_module(COMMANDS[cmd])
    try:
        mod.main(argv[1:])
    finally:
        # a verb run under torchrun joined a process group
        # (cli/common.py::join_process_group): leave it before exiting
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
