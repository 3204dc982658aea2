"""`augment` command (JAX ``cli/augment.py``): offline differential
dataset materialization (reference augment_data.py main, :315-365), the
copies augmented on the card unless ``--device cpu``."""

from __future__ import annotations

import argparse
import logging

from ..augment import AugmentEngine
from ..augment.engine import print_statistics
from ..data.loader import DataPipeline
from ..data.manifest import scan_raw
from .common import (add_config_args, resolve_config, resolve_device,
                     setup_logging)

log = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Materialize the differential-augmented dataset "
                    "(live x8 / spoof x2) with on-device kernels")
    add_config_args(parser)
    args = parser.parse_args(argv)
    setup_logging()
    device = resolve_device(parser, args)
    cfg = resolve_config(args).augment

    records = scan_raw(cfg.input_dir)
    if not records:
        raise FileNotFoundError(f"no images under {cfg.input_dir}")
    engine = AugmentEngine(cfg.live_augmentations, cfg.spoof_augmentations,
                           cfg.img_size, device=device)
    total = 0
    for cls, label in (("live", 1), ("spoof", 0)):
        cls_records = [r for r in records if r.label == label]
        pipe = DataPipeline(cls_records, batch_size=cfg.batch_size,
                            img_size=cfg.img_size, resize="exact")
        batches = (([cls_records[int(i)].path for i in b["index"]],
                    b["image"]) for b in pipe.batches())
        total += engine.materialize(
            batches, cfg.output_dir, cls, quality=cfg.save_quality)
    print_statistics(cfg.input_dir, cfg.output_dir)
    print(f"materialized {total} images into {cfg.output_dir}")
    return total


if __name__ == "__main__":
    main()
