"""The port's offline engine (augment/engine.py) against the JAX package's:
``materialize`` writes the same file names and counts into ``tmp_path``,
logs the same stem collisions, and ``print_statistics`` reports the same
keys and counts; ``augment_copies`` and ``online_batches`` follow the same
plan.  The JAX engine's compiled tier augmenters are replaced by the
identity in the test (the pixels are not what is compared here; the
chains are held against JAX in tests/test_torch_augment.py), so nothing
is compiled on the JAX side.
"""

import logging

import numpy as np
import pytest
import torch
from PIL import Image

from vit_spoof_detection_pda_tpu.augment import engine as JE
from vit_spoof_detection_pda_tpu_torch.augment import engine as TE

SIZE = 16


def _engines(live=3, spoof=2):
    tj = TE.AugmentEngine(live, spoof, img_size=SIZE, seed=0, device="cpu")
    jj = JE.AugmentEngine(live, spoof, img_size=SIZE, seed=0)
    jj._augmenters = {lvl: (lambda key, b: b) for lvl in jj._augmenters}
    return tj, jj


def _inputs(root):
    """Four source files, two of them with the same stem in different
    directories; the batches the data layer would hand over."""
    rng = np.random.default_rng(0)
    paths = []
    for sub, stem in (("a", "x"), ("b", "x"), ("a", "y"), ("b", "z")):
        d = root / "src" / sub / "live"
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"{stem}.png"
        Image.fromarray(rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    u8 = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    return [(paths[:2], u8[:2]), (paths[2:], u8[2:])]


def test_materialize_matches_jax(tmp_path, caplog):
    batches = _inputs(tmp_path)
    tj, jj = _engines()
    out = {}
    for name, eng in (("port", tj), ("jax", jj)):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            saved = eng.materialize(batches, str(tmp_path / name), "live",
                                    quality=90, encode_workers=2)
        collisions = [r.getMessage() for r in caplog.records
                      if "stem collision" in r.getMessage()]
        files = sorted(p.name for p in (tmp_path / name / "live").iterdir())
        out[name] = (saved, files, collisions)
    assert out["port"] == out["jax"]
    saved, files, collisions = out["port"]
    assert saved == 4 * (3 + 1)           # 3 copies + the original each
    assert "x_aug2.jpg" in files and "z_orig.jpg" in files
    assert len(files) == 3 * 4 and len(collisions) == 1
    with Image.open(tmp_path / "port" / "live" / "y_orig.jpg") as im:
        assert im.size == (20, 24)        # native resolution, re-encoded
    want = JE.print_statistics(str(tmp_path / "src"), str(tmp_path / "jax"))
    got = TE.print_statistics(str(tmp_path / "src"), str(tmp_path / "port"))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].keys() == want[k].keys()
        for field in ("live", "spoof", "ratio_spoof_to_live"):
            assert got[k][field] == want[k][field]


def test_write_jpeg_logs_and_counts_zero_on_failure(tmp_path, caplog):
    arr = np.zeros((4, 4, 3), np.uint8)
    with caplog.at_level(logging.ERROR):
        n = TE._write_jpeg(arr, tmp_path / "missing" / "a.jpg", 90)
    assert n == 0 and "error saving" in caplog.text


def test_augment_copies_follow_the_plan():
    tj, _ = _engines(live=8, spoof=2)
    x = torch.rand(2, SIZE, SIZE, 3)
    for cls, n in (("live", 8), ("spoof", 2)):
        copies = list(tj.augment_copies(x, cls))
        assert [(i, lvl) for i, lvl, _ in copies] == [
            (i, JE.severity_for_copy(i, n)) for i in range(n)]
        for _, _, aug in copies:
            assert aug.shape == x.shape and aug.dtype == torch.float32
            assert torch.isfinite(aug).all()
    with pytest.raises(ValueError, match="img_size"):
        next(tj.augment_copies(torch.rand(1, 8, 8, 3), "live"))


def test_engine_draws_replay_from_the_seed():
    x = torch.rand(3, SIZE, SIZE, 3)
    a = [c for _, _, c in _engines()[0].augment_copies(x, "live")]
    b = [c for _, _, c in _engines()[0].augment_copies(x, "live")]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], a[1])


def test_online_batches_match_jax_plan():
    tj, jj = _engines()
    u8 = np.random.default_rng(1).integers(0, 256, (5, SIZE, SIZE, 3),
                                           dtype=np.uint8)
    labels = np.array([1, 0, 0, 1, 0])

    def cls(label):
        return "live" if label == 1 else "spoof"

    got = list(tj.online_batches([(u8, labels)], cls))
    want = list(jj.online_batches([(u8, labels)], cls))
    assert len(got) == len(want) == 1 + 3 + 2
    for (ga, gl), (wa, wl) in zip(got, want):
        assert tuple(ga.shape) == tuple(wa.shape)
        np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0][0]),
                               atol=1e-7)
