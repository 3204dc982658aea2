"""The port's LayerNorm/residual backward against the JAX package's Pallas
kernel in interpret mode (``ops/ln_bwd.py::ln_residual_bwd``), on the same
numpy-seeded operands.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that on the card (tests/test_torch_kernels_cuda.py).

Tolerances: all-f32 operands at atol 1e-5 / rtol 1e-5 (the same f32
formula; the row means and the [D] sums are taken in another order).
With bf16 operands dx is compared within 2 bf16 ulps of its largest
magnitude (both sides round the same f32 value once; a different f32
sum order can flip that rounding by one ulp) and the f32 sums at rtol
1e-5 of their largest magnitude.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_spoof_detection_pda_tpu.ops import ln_bwd as jln
from vit_spoof_detection_pda_tpu_torch.ops import ln_bwd as tln

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operands(seed, b, tq, d, valid=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    xh, dxn, g = f(b, tq, d), f(b, tq, d), f(b, tq, d)
    inv = rng.uniform(0.5, 2.0, (b, tq, 1)).astype(np.float32)
    lns = (1.0 + 0.1 * f(d)).astype(np.float32)
    if valid is not None:                 # padding contract: dxn = g = 0
        dxn[:, valid:] = 0.0
        g[:, valid:] = 0.0
    return xh, inv, dxn, g, lns


def _run(ops, act, dxn_dt):
    xh, inv, dxn, g, lns = ops
    jd, td = DT[act]
    jdx, tdx = DT[dxn_dt]
    want = jln.ln_residual_bwd(
        jnp.asarray(xh, jd), jnp.asarray(inv), jnp.asarray(dxn, jdx),
        jnp.asarray(g, jd), jnp.asarray(lns), interpret=True)
    got = tln.ln_residual_bwd(
        torch.tensor(xh).to(td), torch.tensor(inv), torch.tensor(dxn).to(tdx),
        torch.tensor(g).to(td), torch.tensor(lns))
    return ([t.float().numpy() for t in got],
            [np.asarray(w, np.float32) for w in want])


def _bf16_tol(want):
    amax = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(amax)) - 7)


@pytest.mark.parametrize("b,tq,d", [(2, 16, 64), (3, 40, 128), (1, 200, 96)])
def test_ln_residual_bwd_matches_jax_f32(b, tq, d):
    got, want = _run(_operands(0, b, tq, d), "f32", "f32")
    for gg, ww in zip(got, want):
        np.testing.assert_allclose(gg, ww, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dxn_dt", ["bf16", "f32"])
@pytest.mark.parametrize("b,tq,d", [(2, 24, 64), (3, 200, 128)])
def test_ln_residual_bwd_matches_jax_bf16(b, tq, d, dxn_dt):
    got, want = _run(_operands(1, b, tq, d), "bf16", dxn_dt)
    (gdx, gs, gb), (wdx, ws, wb) = got, want
    assert np.abs(gdx - wdx).max() <= _bf16_tol(wdx)
    for gg, ww in ((gs, ws), (gb, wb)):
        assert np.abs(gg - ww).max() <= 1e-5 * np.abs(ww).max()


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_ln_residual_bwd_pad_rows_are_exactly_zero(act):
    """Odd batch, Tq 200 with 197 real rows: the pad rows' dx is exactly
    0 and the sums equal those of the real rows alone."""
    ops = _operands(2, 3, 200, 64, valid=197)
    got, want = _run(ops, act, act)
    assert (got[0][:, 197:] == 0).all() and (want[0][:, 197:] == 0).all()
    xh, inv, dxn, g, lns = ops
    td = DT[act][1]
    real = tln.ln_residual_bwd(
        torch.tensor(xh[:, :197]).to(td), torch.tensor(inv[:, :197]),
        torch.tensor(dxn[:, :197]).to(td), torch.tensor(g[:, :197]).to(td),
        torch.tensor(lns))
    # the same f32 terms plus exact zeros, grouped otherwise by the sum
    np.testing.assert_allclose(got[1], real[1].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], real[2].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0][:, :197],
                                  real[0].float().numpy())


def test_ln_residual_bwd_plain_matches_jax_reference():
    ops = _operands(3, 2, 17, 32)
    xh, inv, dxn, g, lns = ops
    want = jln.ln_residual_bwd_reference(*(jnp.asarray(a) for a in ops))
    got = tln.ln_residual_bwd_plain(*(torch.tensor(a) for a in ops))
    for gg, ww in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), atol=1e-5,
                                   rtol=1e-5)
    assert got[0].dtype == torch.float32
    assert got[1].shape == got[2].shape == (32,)
