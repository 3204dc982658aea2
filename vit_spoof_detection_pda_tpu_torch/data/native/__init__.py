"""ctypes bindings for the native decode+resize / JPEG encode library
(counterpart of the JAX package's ``data/native``).

``decoder.cpp`` beside this file is the port's own copy of the JAX
package's source.  It is built with ``g++`` against libjpeg and libpng
at first use, into the port's git-ignored build directory
(``build/native/<hash of the source and flags>/libdecoder.so``, beside
``ops/_build.py``'s kernel libraries), never next to the source; each
build writes a file of its own and renames it into place, so concurrent
processes never load a half-written library.  The data pipeline uses
it as its fast path; PIL remains the fallback (``PAD_NATIVE_DECODE=0``
turns the codec off).  This is a host library: nothing of it runs on
the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdecoder.so"


def _build(so: Path) -> Optional[str]:
    """Compile ``decoder.cpp`` to ``so``; the error text on failure."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *CXX_FLAGS, str(SRC), *LIBS, "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, so)
        return None
    except subprocess.CalledProcessError as e:
        return (e.stderr or str(e)).strip()[-2000:]
    except Exception as e:                        # noqa: BLE001
        return f"{type(e).__name__}: {e}"
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None if unavailable
    (:func:`build_error` then says why)."""
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PAD_NATIVE_DECODE", "1") == "0":
            _error = "turned off (PAD_NATIVE_DECODE=0)"
            return None
        so = library_path()
        if not so.exists():
            _error = _build(so)
            if _error is not None:
                log.warning("native codec build failed (%s); using PIL",
                            _error.splitlines()[-1] if _error else "")
                return None
        try:
            lib = ctypes.CDLL(str(so))
            lib.pad_decode_resize.restype = ctypes.c_int
            lib.pad_decode_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.pad_encode_jpeg.restype = ctypes.c_int
            lib.pad_encode_jpeg.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.c_ulong)]
            lib.pad_free.restype = None
            lib.pad_free.argtypes = [ctypes.c_void_p]
            _lib = lib
            log.info("native codec loaded (%s)", so)
        except (OSError, AttributeError) as e:
            _error = f"load failed: {e}"
            log.warning("native codec load failed (%s); using PIL", e)
    return _lib


def build_error() -> Optional[str]:
    """Why :func:`get_lib` returned None (None while it has not, or if
    the codec loaded)."""
    return _error


def native_decode(path: str, size: int, resize: str = "exact"
                  ) -> Optional[np.ndarray]:
    """Decode + resize a JPEG or PNG file to ``(size, size, 3)`` uint8
    through the native codec (``resize="exact"`` or ``"shorter"``, the
    geometry of ``data/loader.py::decode_image``); None on any failure
    (the caller falls back to PIL)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    out = np.empty((size, size, 3), np.uint8)
    mode = 0 if resize == "exact" else 1
    rc = lib.pad_decode_resize(data, len(data), size, mode,
                               out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def native_encode_jpeg(arr: np.ndarray, quality: int = 95
                       ) -> Optional[bytes]:
    """Encode an RGB uint8 HWC array to JPEG bytes through the native
    codec (the GIL released for the whole compress); None on any failure
    (the caller falls back to PIL)."""
    lib = get_lib()
    if lib is None:
        return None
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        return None
    arr = np.ascontiguousarray(arr)
    buf = ctypes.POINTER(ctypes.c_ubyte)()
    size = ctypes.c_ulong()
    rc = lib.pad_encode_jpeg(arr.ctypes.data_as(ctypes.c_void_p),
                             int(arr.shape[0]), int(arr.shape[1]),
                             int(quality), ctypes.byref(buf),
                             ctypes.byref(size))
    if rc != 0 or not buf:
        return None
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.pad_free(buf)


def encode_png(arr: np.ndarray) -> bytes:
    """An RGB uint8 HWC array as PNG bytes, written with the standard
    library alone (``zlib``, ``struct``): lossless, unfiltered rows, so
    a correct decoder gives back the array bit for bit.  For checks on a
    machine without PIL."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"encode_png takes RGB [H, W, 3], got {arr.shape}")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
