"""Serving program tables (the port's counterpart of
``build_programs_live`` in the JAX package's ``serve/server.py``; the HTTP
front end and the artifact loading come with a later slice)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def build_programs_live(model, *, shapes: Sequence[int] = (32, 128),
                        img_size: int = 224, threshold: float = 0.5,
                        temperature=None, device=None):
    """Program table from a live model for the MicroBatcher:
    ``({batch_size: callable}, img_size, metas)``.

    Each shape gets the regime of ``fastserve.auto_serving_mode``; shapes
    sharing a regime share one serving function.  Only the ``fastserve``
    regime (B >= 17) is ported, so a shape <= 16 raises
    ``NotImplementedError``.  ``pred`` is ``prob > threshold``;
    ``temperature`` applies ``sigmoid(logit(p) / T)`` on the host before
    thresholding.  Runs on the card unless ``device="cpu"``."""
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
