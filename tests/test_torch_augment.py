"""The port's augmentation ops, tiers and train-time chain (ops/augment.py,
augment/policy.py, train/driver.py) against the JAX package's.

The two frameworks draw different random numbers, so each test recovers
JAX's draws by replaying the op's own key splits (``apply_chain`` folds
op ``i``'s key out of the sample key, ``_gate`` splits gate and op keys,
``color_jitter`` splits five, ``composed_geometric`` seven) and feeds
them to the port's deterministic ``apply``; the JAX side runs the op
itself.  The warp tower runs JAX's XLA roll form (the CPU path) and the
port's warp-kernel plain version.

Tolerances, beside their reasons:
- f32, each op and each tier: 2e-5 absolute on [0, 1]-scaled images
  (sums and the blur / sharpness convolutions in another order, ``tan``
  and ``sin`` of the rotation, the 8 x 8 solve of the homography; the
  largest gap measured is listed by tests/torch_parity_report.py);
- bf16 chains: 3/64 absolute (a few bf16 ulps at magnitude ~1: each op
  rounds its output to bf16 and a rounding flipped early moves the later
  ops' inputs by an ulp), and mean gap under 1e-3.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.augment import policy as JP
from vit_spoof_detection_pda_tpu.ops import augment as JA
from vit_spoof_detection_pda_tpu_torch.augment import policy as TP
from vit_spoof_detection_pda_tpu_torch.ops import augment as TA
from vit_spoof_detection_pda_tpu_torch.train import driver as TD
from vit_spoof_detection_pda_tpu_torch.train.step import step_generator

F32_TOL = 2e-5
BF16_TOL, BF16_MEAN_TOL = 3 / 64, 1e-3
MEAN = (0.485, 0.456, 0.406)


# --------------------------------------------------------------------------
# replaying JAX's draws
# --------------------------------------------------------------------------


def _u(k, lo, hi, shape=(), dtype=jnp.float32):
    return np.asarray(jax.random.uniform(k, shape, dtype, minval=lo,
                                         maxval=hi))


def _bern(k, p):
    return bool(jax.random.bernoulli(k, p))


def _gated(op, k, body):
    gate_key, fn_key = jax.random.split(k)
    return {"take": _bern(gate_key, op.p), **body(fn_key)}


def _jax_draws(op, k, h, w, c, dtype):
    """The draws JAX's counterpart of ``op`` makes from key ``k`` on one
    ``h x w x c`` image, in the port's params layout (one sample)."""
    if isinstance(op, TA.RandomHFlip):
        return _gated(op, k, lambda fk: {})
    if isinstance(op, TA.RandomRotation):
        return _gated(op, k, lambda fk: {
            "angle": _u(fk, -op.degrees, op.degrees)})
    if isinstance(op, TA.RandomCrop):
        ky, kx = jax.random.split(k)
        return {"top": int(jax.random.randint(ky, (), 0, h - op.size + 1)),
                "left": int(jax.random.randint(kx, (), 0, w - op.size + 1))}
    if isinstance(op, TA.RandomPerspective):
        return _gated(op, k, lambda fk: {"off": _u(fk, 0.0, 1.0, (4, 2))})
    if isinstance(op, TA.ElasticTransform):
        def body(fk):
            kx, ky = jax.random.split(fk)
            return {"noise_x": _u(kx, -1.0, 1.0, (h, w)),
                    "noise_y": _u(ky, -1.0, 1.0, (h, w))}
        return _gated(op, k, body)
    if isinstance(op, TA.ColorJitter):
        def body(fk):
            keys = jax.random.split(fk, 5)
            out = {n: _u(kk, lo, hi) for n, kk, (lo, hi) in
                   zip("bcsh", keys[:4], op.ranges)}
            out["perm"] = np.asarray(jax.random.permutation(keys[4], 4))
            return out
        return _gated(op, k, body)
    if isinstance(op, TA.GaussianBlur):
        return _gated(op, k, lambda fk: {"sigma": _u(fk, *op.sigma_range)})
    if isinstance(op, TA.GaussianNoise):
        return _gated(op, k, lambda fk: {"noise": np.asarray(
            jax.random.normal(fk, (h, w, c), dtype)).astype(np.float32)})
    if isinstance(op, TA.RandomSharpness):
        return _gated(op, k, lambda fk: {"factor": _u(fk, 0.0, op.sharpness)})
    if isinstance(op, TA.RandomErasing):
        def body(fk):
            ka, kr, ky, kx = jax.random.split(fk, 4)
            return {"area": _u(ka, *op.scale),
                    "log_ratio": _u(kr, math.log(op.ratio[0]),
                                    math.log(op.ratio[1])),
                    "top": int(jax.random.randint(ky, (), 0, h)),
                    "left": int(jax.random.randint(kx, (), 0, w))}
        return _gated(op, k, body)
    if isinstance(op, TA.ComposedGeometric):
        kf, kr_gate, kr, kp_gate, kp, ke_gate, ke = jax.random.split(k, 7)
        out = {}
        if op.hflip_p > 0:
            out["flip"] = _bern(kf, op.hflip_p)
        if op.rotation is not None:
            deg, p = op.rotation
            out.update(angle=_u(kr, -deg, deg), rot_gate=_bern(kr_gate, p))
        if op.perspective is not None:
            out.update(off=_u(kp, 0.0, 1.0, (4, 2)),
                       persp_gate=_bern(kp_gate, op.perspective[1]))
        if op.elastic is not None:
            kx, ky = jax.random.split(ke)
            out.update(noise_x=_u(kx, -1.0, 1.0, (h, w), dtype).astype(
                np.float32), noise_y=_u(ky, -1.0, 1.0, (h, w), dtype).astype(
                np.float32), elastic_gate=_bern(ke_gate, op.elastic[3]))
        return out
    raise TypeError(type(op))


def _stack(per_sample, dtype):
    out = {}
    for name in per_sample[0]:
        v = np.stack([np.asarray(p[name]) for p in per_sample])
        t = torch.tensor(v)
        if name.startswith("noise"):
            t = t.to(dtype)
        out[name] = t
    return out


def _port_chain(chain, key, batch, dtype):
    """The port's chain fed JAX's draws of ``apply_chain(key, batch,
    jax_chain)``: op ``i`` of sample ``s`` draws from ``fold_in(split(key,
    B)[s], i)``."""
    b, h, w, c = batch.shape
    keys = jax.random.split(key, b)
    x = torch.tensor(np.asarray(batch, np.float32)).to(dtype)
    for i, op in enumerate(chain):
        draws = [_jax_draws(op, jax.random.fold_in(keys[s], i), x.shape[1],
                            x.shape[2], c, jnp.bfloat16 if dtype ==
                            torch.bfloat16 else jnp.float32)
                 for s in range(b)]
        x = op.apply(x, _stack(draws, dtype))
    return x


def _jax_chain(chain, key, batch, dtype):
    return np.asarray(JA.apply_chain(key, jnp.asarray(batch, dtype), chain)
                      ).astype(np.float32)


def _batch(seed, b=4, h=32, w=32):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


def _check_f32(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def _check_bf16(got, want):
    g = got.float().numpy()
    assert np.abs(g - want).max() <= BF16_TOL
    assert np.abs(g - want).mean() <= BF16_MEAN_TOL


# --------------------------------------------------------------------------
# each op
# --------------------------------------------------------------------------

OPS = {
    "hflip": (lambda: TA.RandomHFlip(0.5),
              lambda k, im: JA.random_hflip(k, im, p=0.5)),
    "rotation": (lambda: TA.RandomRotation(15.0, p=0.7),
                 lambda k, im: JA.random_rotation(k, im, 15.0, p=0.7)),
    "crop": (lambda: TA.RandomCrop(24), lambda k, im: JA.random_crop(k, im, 24)),
    "perspective": (lambda: TA.RandomPerspective(0.3, p=0.7),
                    lambda k, im: JA.random_perspective(k, im, 0.3, p=0.7)),
    "elastic": (lambda: TA.ElasticTransform(p=0.7),
                lambda k, im: JA.elastic_transform(k, im, p=0.7)),
    "jitter_random_unit": (
        lambda: TA.ColorJitter(0.4, 0.4, 0.4, 0.2, p=0.8),
        lambda k, im: JA.color_jitter(k, im, 0.4, 0.4, 0.4, 0.2, p=0.8)),
    "jitter_fixed_normalized": (
        lambda: TA.ColorJitter(0.4, 0.4, 0.4, 0.2, p=0.8, order="fixed",
                               domain="normalized"),
        lambda k, im: JA.color_jitter(k, im, 0.4, 0.4, 0.4, 0.2, p=0.8,
                                      order="fixed", domain="normalized")),
    "blur": (lambda: TA.GaussianBlur(5, (0.1, 2.0), p=0.7),
             lambda k, im: JA.gaussian_blur(k, im, 5, (0.1, 2.0), p=0.7)),
    "noise": (lambda: TA.GaussianNoise(std=(0.01, 0.02, 0.03), p=0.7),
              lambda k, im: JA.gaussian_noise(k, im, std=(0.01, 0.02, 0.03),
                                              p=0.7)),
    "sharpness": (lambda: TA.RandomSharpness(2.0, p=0.7),
                  lambda k, im: JA.random_sharpness(k, im, 2.0, p=0.7)),
    "erasing": (lambda: TA.RandomErasing(p=0.7),
                lambda k, im: JA.random_erasing(k, im, p=0.7)),
    "composed_tower_fill": (
        lambda: TA.ComposedGeometric(hflip_p=0.5, rotation=(20.0, 0.7),
                                     perspective=(0.2, 0.7),
                                     elastic=(1.0, 32.0, 63, 0.7), fill=MEAN),
        lambda k, im: JA.composed_geometric(
            k, im, hflip_p=0.5, rotation=(20.0, 0.7), perspective=(0.2, 0.7),
            elastic=(1.0, 32.0, 63, 0.7), fill=MEAN)),
    "composed_gather": (
        lambda: TA.ComposedGeometric(hflip_p=0.5, rotation=(20.0, 0.7),
                                     perspective=(0.2, 0.7),
                                     elastic=(1.0, 32.0, 63, 0.7),
                                     sampler="gather"),
        lambda k, im: JA.composed_geometric(
            k, im, hflip_p=0.5, rotation=(20.0, 0.7), perspective=(0.2, 0.7),
            elastic=(1.0, 32.0, 63, 0.7), sampler="gather")),
    "composed_affine": (
        lambda: TA.ComposedGeometric(hflip_p=0.5, rotation=(10.0, 0.7)),
        lambda k, im: JA.composed_geometric(k, im, hflip_p=0.5,
                                            rotation=(10.0, 0.7))),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax_f32(name):
    port_op, jax_op = OPS[name]
    key = jax.random.PRNGKey(len(name))
    batch = _batch(1, b=6)
    want = _jax_chain([jax_op], key, batch, jnp.float32)
    got = _port_chain([port_op()], key, batch, torch.float32)
    _check_f32(got, want)


def test_gated_off_samples_pass_through_bit_for_bit():
    x = torch.tensor(_batch(2)).bfloat16()
    take = torch.tensor([True, False, True, False])
    for op, params in (
            (TA.ColorJitter(0.4, 0.4, 0.4, 0.2), {
                "take": take, "b": torch.full((4,), 1.3),
                "c": torch.full((4,), 0.7), "s": torch.full((4,), 1.2),
                "h": torch.full((4,), 0.1),
                "perm": torch.arange(4).repeat(4, 1)}),
            (TA.GaussianBlur(3, (1.0, 1.0)), {"take": take,
                                              "sigma": torch.ones(4)}),
            (TA.RandomSharpness(), {"take": take,
                                    "factor": torch.full((4,), 1.7)})):
        y = op.apply(x, params)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y[~take], x[~take])
        assert not torch.equal(y[take], x[take])


# --------------------------------------------------------------------------
# the tiers and the train-time chain
# --------------------------------------------------------------------------

CHAINS = {
    "heavy": (TP.heavy_chain, JP.heavy_chain, 32),
    "medium": (TP.medium_chain, JP.medium_chain, 32),
    "light": (TP.light_chain, JP.light_chain, 32),
    "train_time": (lambda: TP.train_time_chain(crop_size=32),
                   lambda: JP.train_time_chain(crop_size=32), 40),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_matches_jax_f32(name):
    port_chain, jax_chain, size = CHAINS[name]
    key = jax.random.PRNGKey(7)
    batch = _batch(3, b=6, h=size, w=size)
    want = _jax_chain(jax_chain(), key, batch, jnp.float32)
    got = _port_chain(port_chain(), key, batch, torch.float32)
    _check_f32(got, want)


@pytest.fixture
def jax_tpu_warp_path(monkeypatch):
    """JAX's warp passes on the TPU path (the Pallas kernel, interpret
    mode): f32 arithmetic in a bf16 chain, as the port computes; the CPU
    roll form computes a bf16 chain's passes in bf16."""
    import functools

    from vit_spoof_detection_pda_tpu.ops import warp as JW
    from vit_spoof_detection_pda_tpu.ops import warp_pallas as WP

    monkeypatch.setattr(JW, "_use_pallas_rolls", lambda: True)
    for name in ("resample_rows_field_pallas", "resample_cols_field_pallas"):
        monkeypatch.setattr(WP, name, functools.partial(getattr(WP, name),
                                                        interpret=True))


@pytest.mark.parametrize("name", ["heavy", "train_time"])
def test_chain_matches_jax_bf16(name, jax_tpu_warp_path):
    port_chain, jax_chain, size = CHAINS[name]
    key = jax.random.PRNGKey(8)
    batch = _batch(4, b=6, h=size, w=size)
    batch = np.asarray(jnp.asarray(batch, jnp.bfloat16).astype(jnp.float32))
    want = _jax_chain(jax_chain(), key, batch, jnp.bfloat16)
    got = _port_chain(port_chain(), key, batch, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _check_bf16(got, want)


def test_tiers_and_plan_match_jax():
    for lvl in ("heavy", "medium", "light"):
        assert len(TP.CHAINS[lvl]()) == len(JP.CHAINS[lvl]())
    for n in range(1, 10):
        for i in range(n):
            assert TP.severity_for_copy(i, n) == JP.severity_for_copy(i, n)
    assert TP.differential_plan() == JP.differential_plan()
    assert TP.differential_plan(5, 3) == JP.differential_plan(5, 3)


# --------------------------------------------------------------------------
# the port's own draws
# --------------------------------------------------------------------------


def _binomial_ok(hits, n, p):
    return abs(hits - n * p) <= 5 * math.sqrt(n * p * (1 - p)) + 1


def test_samplers_ranges_and_gate_frequencies():
    n = 4000
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(n, 8, 8, 3)
    jit = TA.ColorJitter(0.4, 0.3, 0.2, 0.1, p=0.8)
    d = jit.draw(gen, x)
    assert _binomial_ok(int(d["take"].sum()), n, 0.8)
    for name, (lo, hi) in zip("bcsh", jit.ranges):
        assert lo <= float(d[name].min()) and float(d[name].max()) <= hi
        assert abs(float(d[name].mean()) - (lo + hi) / 2) < 0.02
    assert torch.equal(d["perm"].sort(-1).values,
                       torch.arange(4).expand(n, 4))
    geo = TA.ComposedGeometric(hflip_p=0.5, rotation=(20.0, 0.7),
                               perspective=(0.2, 0.4),
                               elastic=(1.0, 32.0, 63, 0.3))
    d = geo.draw(gen, x)
    for name, p in (("flip", 0.5), ("rot_gate", 0.7), ("persp_gate", 0.4),
                    ("elastic_gate", 0.3)):
        assert _binomial_ok(int(d[name].sum()), n, p), name
    assert d["angle"].abs().max() <= 20.0
    assert 0.0 <= float(d["off"].min()) and float(d["off"].max()) < 1.0
    assert d["noise_y"].abs().max() <= 1.0 and d["noise_y"].shape == (n, 8, 8)
    er = TA.RandomErasing(p=0.25).draw(gen, x)
    assert _binomial_ok(int(er["take"].sum()), n, 0.25)
    assert 0.02 <= float(er["area"].min()) and float(er["area"].max()) <= 0.33
    assert int(er["top"].max()) < 8 and int(er["left"].min()) >= 0
    crop = TA.RandomCrop(5).draw(gen, x)
    assert int(crop["top"].max()) <= 3 and int(crop["left"].min()) >= 0
    noise = TA.GaussianNoise().draw(gen, x)["noise"]
    assert abs(float(noise.std()) - 1.0) < 0.02


def test_prep_replays_by_seed_and_step():
    """The train step's prep draws from step_generator(seed, step, salt):
    the same (seed, step) replays the same augmentation."""
    prep = TD.make_prep_fn(TD.group_chains()["heavy"])
    u8 = torch.tensor(np.random.default_rng(5).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))

    def run(step):
        return prep(step_generator(3, step, "cpu", 104729), u8)

    a, b, c = run(7), run(7), run(8)
    assert a.dtype == torch.float32 and a.shape == (4, 32, 32, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_group_chains_follow_the_driver():
    chains = TD.group_chains()
    assert set(chains) == {"orig", "heavy", "medium", "light"}
    assert len(chains["orig"]) == 4            # no crop: inputs at size
    for g in ("heavy", "medium", "light"):
        assert len(chains[g]) == len(TP.CHAINS[g]()) + 4
    assert TD.group_chains(enabled=False)["orig"] == []
