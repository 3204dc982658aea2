"""The port's native codec (``data/native``: its own copy of
``decoder.cpp``, built into the port's ``build/native``) against the JAX
package's: decoding, JPEG encoding, ``decode_image`` with its PIL
fallback, ``encode_png``, the switch ``PAD_NATIVE_DECODE=0``, a failed
build, the JPEG writer of ``augment/engine.py``, and the doctor's
``native_codec`` check.

Every comparison is byte for byte: the two packages build the same
source with the same flags and call it the same way.  The cases skip
where this machine cannot build the codec (no g++, libjpeg or libpng).
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vit_spoof_detection_pda_tpu.data import loader as jloader
from vit_spoof_detection_pda_tpu.data import native as jnative
from vit_spoof_detection_pda_tpu_torch.augment import engine as tengine
from vit_spoof_detection_pda_tpu_torch.cli import doctor
from vit_spoof_detection_pda_tpu_torch.data import loader as tloader
from vit_spoof_detection_pda_tpu_torch.data import native as tnative

ROOT = Path(__file__).resolve().parents[1]
JAX_NATIVE = ROOT / "vit_spoof_detection_pda_tpu" / "data" / "native"
SIZES = (24, 96, 224)


@pytest.fixture(scope="module")
def libs():
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip(f"native codec unavailable here "
                    f"({tnative.build_error()})")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded PNG and JPEG files: a smooth image and a noisy one, landscape
    and portrait, large enough for libjpeg's DCT-domain prescale."""
    d = tmp_path_factory.mktemp("codec")
    rng = np.random.default_rng(0)
    out = []
    for i, (h, w) in enumerate([(240, 320), (500, 380)]):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([yy / h, xx / w,
                         0.5 + 0.3 * np.sin(yy / 9) * np.cos(xx / 7)], -1)
        u8 = np.clip(base * 255 + rng.integers(-30, 30, base.shape), 0,
                     255).astype(np.uint8)
        for ext, kw in ((".png", {}), (".jpg", {"quality": 90})):
            p = d / f"img{i}{ext}"
            Image.fromarray(u8).save(p, **kw)
            out.append(p)
    return out


@pytest.mark.parametrize("resize", ["exact", "shorter"])
@pytest.mark.parametrize("size", SIZES)
def test_native_decode_is_byte_equal_to_jax(libs, files, size, resize):
    for p in files:
        got = tnative.native_decode(str(p), size, resize)
        want = jnative.native_decode(str(p), size, resize)
        assert got is not None and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want, err_msg=p.name)


@pytest.mark.parametrize("resize", ["exact", "shorter"])
def test_decode_image_equals_jax_with_and_without_the_codec(
        libs, files, tmp_path, resize):
    """The native path, and PIL for what it declines (a BMP), alike; a
    corrupt file decodes to the black frame in both."""
    bmp = tmp_path / "img.bmp"
    Image.open(files[0]).save(bmp)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8garbage")
    for p in [*files, bmp, bad]:
        np.testing.assert_array_equal(
            tloader.decode_image(str(p), 64, resize),
            jloader.decode_image(str(p), 64, resize), err_msg=p.name)
    assert tnative.native_decode(str(bmp), 64, resize) is None
    assert not tloader.decode_image(str(bad), 64, resize).any()


@pytest.mark.parametrize("quality", [75, 95])
def test_native_encode_jpeg_is_byte_equal_to_jax(libs, quality):
    rng = np.random.default_rng(quality)
    for shape in ((64, 48, 3), (224, 224, 3)):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        got = tnative.native_encode_jpeg(arr, quality)
        assert got is not None and got[:2] == b"\xff\xd8"
        assert got == jnative.native_encode_jpeg(arr, quality)
    assert tnative.native_encode_jpeg(arr[..., :2].copy(), quality) is None


def test_engine_writes_the_native_jpeg(libs, tmp_path):
    arr = np.random.default_rng(3).integers(0, 256, (40, 56, 3),
                                            dtype=np.uint8)
    assert tengine._write_jpeg(arr, tmp_path / "a.jpg", 95) == 1
    assert (tmp_path / "a.jpg").read_bytes() == \
        tnative.native_encode_jpeg(arr, 95)


def test_encode_png_decodes_bit_exact(libs, tmp_path):
    arr = np.random.default_rng(4).integers(0, 256, (37, 53, 3),
                                            dtype=np.uint8)
    p = tmp_path / "a.png"
    p.write_bytes(tnative.encode_png(arr))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), arr)
    want = Image.fromarray(arr).resize((53, 53), Image.BILINEAR)
    np.testing.assert_array_equal(tnative.native_decode(str(p), 53),
                                  np.asarray(want))


def test_the_library_lands_in_the_ports_build_dir(libs, tmp_path,
                                                  monkeypatch):
    """A fresh build writes only under the build root it is given (the
    repo's ``build/native`` by default), and nothing next to either
    package's source."""
    assert tnative.library_path().is_relative_to(ROOT / "build" / "native")
    assert tnative.library_path().exists()
    before = sorted(JAX_NATIVE.iterdir())
    port_dir = sorted(Path(tnative.SRC).parent.iterdir())
    mod = importlib.reload(tnative)
    try:
        monkeypatch.setattr(mod, "BUILD_ROOT", tmp_path / "native")
        assert mod.get_lib() is not None
        assert [p.name for p in (tmp_path / "native").rglob("*")
                if p.is_file()] == ["libdecoder.so"]
    finally:
        importlib.reload(tnative)
    assert sorted(JAX_NATIVE.iterdir()) == before
    assert sorted(Path(tnative.SRC).parent.iterdir()) == port_dir


def test_switch_off_and_failed_build_fall_back(tmp_path, monkeypatch):
    mod = importlib.reload(tnative)
    try:
        monkeypatch.setenv("PAD_NATIVE_DECODE", "0")
        assert mod.get_lib() is None and "PAD_NATIVE_DECODE" in \
            mod.build_error()
        assert mod.native_decode(__file__, 8) is None
        monkeypatch.delenv("PAD_NATIVE_DECODE")
        mod = importlib.reload(tnative)
        bad = tmp_path / "decoder.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(mod, "SRC", bad)
        monkeypatch.setattr(mod, "BUILD_ROOT", tmp_path / "native")
        assert mod.get_lib() is None and mod.build_error()
        assert mod.native_encode_jpeg(np.zeros((4, 4, 3), np.uint8)) is None
        (r,) = doctor.run_doctor(["native_codec"])
        assert r["status"] == doctor.WARN and r["build_error"]
    finally:
        importlib.reload(tnative)


def test_doctor_native_codec_ok_and_fail(libs, monkeypatch):
    (r,) = doctor.run_doctor(["native_codec"])
    assert r["status"] == doctor.OK and r["png_roundtrip"] == "bit-exact"
    monkeypatch.setattr(tnative, "native_decode",
                        lambda *a, **k: np.zeros((32, 32, 3), np.uint8))
    (r,) = doctor.run_doctor(["native_codec"])
    assert r["status"] == doctor.FAIL and "bit-exact" in r["error"]
