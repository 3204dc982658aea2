"""Image decoding for the serving front (the port's copy of
``decode_image_bytes`` and ``_pil_to_sized_rgb`` from the JAX package's
``data/loader.py``; the dataset pipeline comes with a later slice).

PIL is imported inside the functions, so the module imports where PIL
is not installed; only an encoded upload needs it.
"""

from __future__ import annotations

import io

import numpy as np


def _pil_to_sized_rgb(im, size: int, resize: str) -> np.ndarray:
    """RGB-convert and resize an open PIL image to (size, size, 3) uint8.
    ``resize="exact"``: (size, size).  ``resize="shorter"``: the shorter
    side to ``size`` keeping the aspect ratio, then a center crop of the
    longer side to ``size``."""
    from PIL import Image

    im = im.convert("RGB")
    if resize == "exact":
        im = im.resize((size, size), Image.BILINEAR)
    else:
        w, h = im.size
        # half away from zero, like the native decoder's lround; Python's
        # round() rounds halves to even and would pick another grid
        if w <= h:
            nw, nh = size, max(1, int(h * size / w + 0.5))
        else:
            nw, nh = max(1, int(w * size / h + 0.5)), size
        im = im.resize((nw, nh), Image.BILINEAR)
        left = (nw - size) // 2
        top = (nh - size) // 2
        im = im.crop((left, top, left + size, top + size))
    return np.asarray(im, dtype=np.uint8)


def decode_image_bytes(data: bytes, size: int,
                       resize: str = "exact") -> np.ndarray:
    """Decode in-memory image bytes to (size, size, 3) uint8 RGB.  Raises
    ``ValueError`` on undecodable input: a scoring service rejects a
    corrupt upload rather than score a black frame."""
    from PIL import Image
    try:
        with Image.open(io.BytesIO(data)) as im:
            return _pil_to_sized_rgb(im, size, resize)
    except Exception as e:                       # noqa: BLE001
        raise ValueError(f"undecodable image bytes ({e})") from e
