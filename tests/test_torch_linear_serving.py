"""The linear-head serving forwards and ``fuse_mlp=False`` of the port
(``models/fastserve.py``) against the JAX package's (Pallas kernels in
interpret mode) on the same folded weights and uint8 images; the
linear-head converter; ``make_fastserve_infer`` on both heads; and the
harness putting ``Base_ViT_Pretrained`` on the serving path, as JAX does.

Bounds are ``tests/test_torch_fastserve.py``'s: atol 2e-4 / rtol 1e-4 at
f32, ``BF16_SCORE_ATOL`` (5e-3) at bf16.  With ``fuse_mlp=False`` the port
runs fc1 and fc2 on the GEMM core, which rounds each output once after its
epilogue, where JAX rounds ``acc + b`` before the GELU and fc2's output
before the residual: at f32 the two are the same math; at bf16 they differ
by those roundings, inside the bf16 bound.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.eval import runner as jrunner
from vit_spoof_detection_pda_tpu.models import fastserve as jfast
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch.data.manifest import scan_test
from vit_spoof_detection_pda_tpu_torch.eval import harness as tharness
from vit_spoof_detection_pda_tpu_torch.eval import runner as trunner
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.ops import gemm as tgemm

from test_fastserve import _TinyLinearViT
from util_synthetic import make_subject_tree

IMG = 32
GEOM = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2)
BF16_SCORE_ATOL = 5e-3
F32 = dict(atol=2e-4, rtol=1e-4)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return F32 if name == "f32" else dict(atol=BF16_SCORE_ATOL, rtol=0)


def _images(seed, b):
    return np.random.default_rng(seed).integers(
        0, 256, (b, IMG, IMG, 3), dtype=np.uint8)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def linear():
    """The JAX tiny linear-head ViT, its folded params, and the port's
    ViTLinearHead at the same geometry holding the same weights."""
    jm = _TinyLinearViT()
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)))
    folded = jvit.fold_normalization(variables)
    tm = tvit.ViTLinearHead(**GEOM, img_size=IMG).eval()
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        tconvert.vit_linear_to_torch(
                            _np_tree(variables)).items()})
    return jm, variables, folded, tm


@pytest.fixture(scope="module")
def antispoof():
    jm = jvit.ViTAntiSpoof(**GEOM, hidden=16, gelu="tanh")
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    tm = tconvert.load_jax_params(
        tvit.ViTAntiSpoof(**GEOM, hidden=16, gelu="tanh", img_size=IMG),
        _np_tree(variables)).eval()
    return jm, variables, jvit.fold_normalization(variables), tm


@pytest.mark.parametrize("fuse_mlp", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b", [4, 3])
def test_serving_forward_linear_matches_jax(linear, dt, b, fuse_mlp):
    _jm, _v, folded, _tm = linear
    tdt, jdt = DTYPES[dt]
    u8 = _images(20 + b, b)
    got = tfast.serving_forward_linear(
        _np_tree(folded["params"]), u8, num_heads=2, depth=2, dtype=tdt,
        fuse_mlp=fuse_mlp, device="cpu").numpy()
    want = np.asarray(jfast.serving_forward_linear(
        folded["params"], jnp.asarray(u8), num_heads=2, depth=2, dtype=jdt,
        fuse_mlp=fuse_mlp, interpret=True), np.float32)
    assert got.shape == (b, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **_tol(dt))
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b", [4, 3])
def test_serving_forward_unfused_mlp_matches_jax(antispoof, dt, b):
    _jm, _v, folded, _tm = antispoof
    tdt, jdt = DTYPES[dt]
    u8 = _images(30 + b, b)
    got = tfast.serving_forward(
        _np_tree(folded["params"]), u8, num_heads=2, depth=2, dtype=tdt,
        fuse_mlp=False, device="cpu").numpy()
    want = np.asarray(jfast.serving_forward(
        folded["params"], jnp.asarray(u8), num_heads=2, depth=2, dtype=jdt,
        fuse_mlp=False, interpret=True), np.float32)
    np.testing.assert_allclose(got, want, **_tol(dt))


def test_unfused_mlp_runs_the_gemm_core_twice_a_layer(antispoof,
                                                      monkeypatch):
    """fuse_mlp=False calls ops/gemm.py::gemm with kernel 2's epilogues,
    fc1 then fc2, and never kernel 2's wrapper."""
    _jm, _v, folded, _tm = antispoof
    calls = []
    real = tfast.gemm

    def spy(a, w, bias, *, epilogue="bias", residual=None):
        calls.append(epilogue)
        return real(a, w, bias, epilogue=epilogue, residual=residual)

    def no_mlp_block(*a, **k):
        raise AssertionError("kernel 2 ran with fuse_mlp=False")

    monkeypatch.setattr(tfast, "gemm", spy)
    monkeypatch.setattr(tfast, "fused_mlp_block", no_mlp_block)
    tfast.serving_forward(_np_tree(folded["params"]), _images(1, 2),
                          num_heads=2, depth=2, fuse_mlp=False, device="cpu")
    assert calls == ["bias_gelu", "bias_residual"] * 2
    assert tgemm.LAUNCHES["gemm"] == 0           # the CPU runs gemm_plain


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lowlat_linear_matches_jax(linear, dt, caplog):
    """The head-less tree packs encoder-only (no "aux": the fold-ends
    packs hold the anti-spoof head, so prepare_lowlat's fallback warns and
    packs none), and the B = 1 / 2 forward matches JAX's."""
    _jm, _v, folded, _tm = linear
    tdt, jdt = DTYPES[dt]
    prepared = tfast.prepare_lowlat(_np_tree(folded["params"]), depth=2,
                                    dtype=tdt, device="cpu")
    assert "aux" not in prepared and "packed_w" in prepared
    assert "fold-ends unavailable" in caplog.text
    jprep = jfast.prepare_lowlat(folded["params"], depth=2, dtype=jdt)
    for b in (1, 2):
        u8 = _images(40 + b, b)
        got = tfast.serving_forward_lowlat_linear(
            prepared, u8, num_heads=2, dtype=tdt, device="cpu").numpy()
        want = np.asarray(jfast.serving_forward_lowlat_linear(
            jprep, jnp.asarray(u8), num_heads=2, dtype=jdt, interpret=True),
            np.float32)
        np.testing.assert_allclose(got, want, **_tol(dt))
        trunk = tfast.serving_forward_linear(
            _np_tree(folded["params"]), u8, num_heads=2, depth=2, dtype=tdt,
            device="cpu").numpy()
        np.testing.assert_allclose(got, trunk, **_tol(dt))


def test_linear_classifier_stays_f32_in_the_prepared_tree(linear):
    _jm, _v, folded, _tm = linear
    prep = tfast.prepare_params(_np_tree(folded["params"]),
                                dtype=torch.bfloat16, device="cpu")
    assert prep["classifier"]["kernel"].dtype == torch.float32
    assert prep["vit"]["block0"]["mlp"]["fc1"]["kernel"].dtype == \
        torch.bfloat16
    np.testing.assert_array_equal(prep["classifier"]["kernel"].numpy(),
                                  np.asarray(folded["params"]["classifier"]
                                             ["kernel"]))


def test_vit_linear_from_torch_round_trip(linear):
    _jm, variables, _f, tm = linear
    back = tconvert.vit_linear_from_torch(tm.state_dict())
    want = _np_tree(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_b) == len(flat_w)
    for path, leaf in flat_b:
        np.testing.assert_array_equal(leaf, flat_w[path], err_msg=str(path))
    again = tconvert.vit_linear_to_torch(back)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(again[k], v.numpy(), err_msg=k)


def test_make_fastserve_infer_antispoof_matches_jax(antispoof):
    jm, variables, _f, tm = antispoof
    u8 = _images(5, 4)
    jinfer, jparams = jrunner.make_fastserve_infer(jm, variables,
                                                   interpret=True)
    want = jinfer(jparams, jnp.asarray(u8))
    got = trunner.make_fastserve_infer(tm, device="cpu")(u8)
    np.testing.assert_allclose(got["prob1"].numpy(), np.asarray(
        want["prob1"]), atol=BF16_SCORE_ATOL)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  got["prob1"].numpy() > 0.5)


def test_make_fastserve_infer_linear_scores_softmax_column_1(linear):
    """The linear head on the serving path: P(live) = softmax column 1 of
    JAX's serving_forward_linear at the same geometry (JAX's
    make_fastserve_infer pins ViT-B/16 for this head)."""
    _jm, _v, folded, tm = linear
    u8 = _images(6, 4)
    got = trunner.make_fastserve_infer(tm, device="cpu")(u8)
    want = np.asarray(jfast.serving_forward_linear(
        folded["params"], jnp.asarray(u8), num_heads=2, depth=2,
        interpret=True), np.float32)[:, 1]
    np.testing.assert_allclose(got["prob1"].numpy(), want,
                               atol=BF16_SCORE_ATOL)
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  got["prob1"].numpy() > 0.5)


def test_make_fastserve_infer_refuses_other_modules():
    class Other(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

    with pytest.raises(TypeError, match="fastserve eval supports "
                       "ViTAntiSpoof and ViTLinearHead"):
        trunner.make_fastserve_infer(Other())


def test_cross_model_eval_serves_the_linear_head_on_fastserve(tmp_path,
                                                              monkeypatch):
    """evaluate-all --fastserve scores Base_ViT_Pretrained on the serving
    path, as the JAX harness does ((ViTAntiSpoof, ViTLinearHead)), and its
    written scores are the serving path's."""
    make_subject_tree(tmp_path / "tree", subjects=2, per_class=3, size=IMG)
    records = scan_test(str(tmp_path / "tree"))
    served = []
    real = trunner.make_fastserve_infer

    def spy(module, **kw):
        served.append(module)
        return real(module, **kw)

    monkeypatch.setattr(trunner, "make_fastserve_infer", spy)
    name = "Base_ViT_Pretrained"
    res = tharness.run_cross_model_eval(
        records, output_dir=str(tmp_path / "out"), model_names=[name],
        batch_size=4, img_size=IMG, fastserve=True, device="cpu")
    assert list(res) == [name] and len(served) == 1
    assert isinstance(served[0], tvit.ViTLinearHead)
    want = trunner.run_inference(served[0], records, batch_size=4,
                                 img_size=IMG, fastserve=True)
    with open(tmp_path / "out" / name / "per_image_predictions.csv") as f:
        got = np.array([float(r["spoof_score"]) for r in csv.DictReader(f)],
                       np.float32)
    np.testing.assert_array_equal(
        got, (1.0 - want["prob1"].astype(np.float64)).astype(np.float32))


def test_benchmark_lowlat_runs_the_linear_head(capsys):
    """benchmark --lowlat on Base_ViT_Pretrained: the encoder-only kernel
    (its plain version here) and softmax column 1, with the latency keys;
    --lowlat-batch-grid and --lowlat-int8 on that model stay refused."""
    import json

    from vit_spoof_detection_pda_tpu_torch.cli import benchmark as tbench
    base = ["--device-latency", "--lowlat", "--n1", "1", "--batch-size", "1",
            "--device", "cpu", "--set", "data.img_size=32", "--model",
            "Base_ViT_Pretrained"]
    out = tbench.main(base)
    lines = capsys.readouterr().out.strip().splitlines()
    assert "lowlat flavor: encoder-only (plain stem/head)" in lines
    line = json.loads(lines[-1])
    assert line == json.loads(json.dumps(out))
    assert {"batch_size", "ms_per_exec", "ms_per_image",
            "images_per_second", "device"} == set(line)
    for flag in ("--lowlat-batch-grid", "--lowlat-int8"):
        with pytest.raises(SystemExit) as e:
            tbench.main(base + [flag])
        assert e.value.code == 2
