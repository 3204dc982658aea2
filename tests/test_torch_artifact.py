"""The port's serving artifacts (models/artifact.py) and the verbs around
them (export-serving, predict, serve, serve-bench, describe, benchmark
--artifact), against the JAX package's artifacts and live serving paths
on the same weights.  The cases mirror tests/test_artifact.py; the fleet
ones run on two ranks in tests/test_torch_sharded_serving.py, and here
a fleet over a model axis exports with its weights replicated.

Tolerances:
- a port module artifact against a JAX module artifact (both f32 on the
  CPU, the same weights): prob1 within 1e-6 (the two f32 forwards sum in
  other orders; the scores are of order 0.5), pred equal;
- kernel-mode artifacts against the live ``make_serving_fn`` on the CPU:
  bit-equal (the frozen program runs the same plain versions);
- packed leaves against a JAX artifact exported from this CPU host:
  byte-equal, but for the fold-ends ``aux`` rows, within two f32 ulps of
  their largest magnitude: they carry the folded patch-embed bias
  ``b - shift @ k`` (``models/vit.py::fold_normalization``), a dot product
  the two packages sum in other orders;
- predict's CSV against ``score_records`` and the HTTP answers against
  direct artifact calls: 1e-6 (a float printed and parsed back).
"""

import csv
import json
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.cli import describe as jdescribe
from vit_spoof_detection_pda_tpu.models import artifact as JA
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch import __main__ as tmain
from vit_spoof_detection_pda_tpu_torch.cli import benchmark as tbench
from vit_spoof_detection_pda_tpu_torch.cli import describe as tdescribe
from vit_spoof_detection_pda_tpu_torch.cli import export_serving as texport
from vit_spoof_detection_pda_tpu_torch.cli import predict as tpredict
from vit_spoof_detection_pda_tpu_torch.cli import serve as tserve_cli
from vit_spoof_detection_pda_tpu_torch.cli import serve_bench as tbench_cli
from vit_spoof_detection_pda_tpu_torch.data import loader
from vit_spoof_detection_pda_tpu_torch.data.manifest import Record
from vit_spoof_detection_pda_tpu_torch.eval.runner import make_infer_fn
from vit_spoof_detection_pda_tpu_torch.models import artifact as A
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import fastserve as tfast
from vit_spoof_detection_pda_tpu_torch.models import vit as tvit
from vit_spoof_detection_pda_tpu_torch.ops import _build
from vit_spoof_detection_pda_tpu_torch.serve import server as tserver

MODULE_ATOL = 1e-6
GEOM = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2, hidden=16)
IMG = 32
# the fold-ends geometry (patch_dim 48 == D), so lowlat runs fold-ends
FOLD = dict(patch_size=4, embed_dim=48, depth=2, num_heads=2, hidden=16)
FOLD_IMG = 8
PACKED = ("packed_w", "packed_s", "end_w", "end_s", "aux", "bg_w", "bg_s")
TINY_SET = ["--set", "model.embed_dim=64", "--set", "model.depth=2",
            "--set", "model.num_heads=2", "--set", "model.head_hidden=16",
            "--set", f"data.img_size={IMG}"]


def _models(geom, img, gelu="erf"):
    jm = jvit.ViTAntiSpoof(**geom, gelu=gelu)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))
    tm = tvit.ViTAntiSpoof(**geom, gelu=gelu, img_size=img).eval()
    tconvert.load_jax_params(tm, jax.tree.map(np.asarray, variables))
    return jm, variables, tm


@pytest.fixture(scope="module")
def vit():
    return _models(GEOM, IMG)


@pytest.fixture(scope="module")
def foldable():
    return _models(FOLD, FOLD_IMG, gelu="tanh")


@pytest.fixture(scope="module")
def module_art(vit, tmp_path_factory):
    """One symbolic-batch port module artifact, shared."""
    _jm, _v, tm = vit
    out = tmp_path_factory.mktemp("art") / "module"
    A.save_serving_artifact(out, tm, mode="module", img_size=IMG)
    return out


def _u8(b, seed, img=IMG):
    return np.random.default_rng(seed).integers(0, 256, (b, img, img, 3),
                                                dtype=np.uint8)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------
# module artifacts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"threshold": 0.3, "temperature": 1.7}],
                         ids=["default", "threshold_temperature"])
def test_module_artifact_matches_jax_module_artifact(vit, tmp_path, kw):
    jm, variables, tm = vit
    JA.save_serving_artifact(tmp_path / "jax", jm, variables, mode="module",
                             batch_size=None, img_size=IMG, **kw)
    meta = A.save_serving_artifact(tmp_path / "port", tm, mode="module",
                                   img_size=IMG, **kw)
    assert meta["batch_size"] is None
    assert meta["platforms"] == ["cpu", "cuda"]
    jart = JA.load_serving_artifact(tmp_path / "jax")
    tart = A.load_serving_artifact(tmp_path / "port", device="cpu")
    assert tart.threshold == kw.get("threshold", 0.5)
    assert tart.temperature == kw.get("temperature")
    for b in (1, 3, 5):
        u8 = _u8(b, b)
        want, got = jart(jnp.asarray(u8)), tart(u8)
        np.testing.assert_allclose(_np(got["prob1"]), np.asarray(
            want["prob1"]), atol=MODULE_ATOL, rtol=0)
        np.testing.assert_array_equal(_np(got["pred"]),
                                      np.asarray(want["pred"]))


def test_module_artifact_equals_live_infer_fn(vit, module_art):
    """The frozen program is the live eval program (eval/runner.py); the
    weights are its inputs, so the program file holds no copy of them."""
    _jm, _v, tm = vit
    assert ((module_art / "serving.pt2").stat().st_size
            < (module_art / "weights.npz").stat().st_size)
    art = A.load_serving_artifact(module_art, device="cpu")
    infer = make_infer_fn(tm)
    for b in (2, 3):
        u8 = _u8(b, 10 + b)
        got, want = art(u8), infer(torch.from_numpy(u8))
        assert torch.equal(got["prob1"], want["prob1"])
        assert torch.equal(got["pred"], want["pred"])


def test_module_artifact_fixed_batch_shape_check(vit, tmp_path):
    _jm, _v, tm = vit
    A.save_serving_artifact(tmp_path / "art", tm, mode="module",
                            batch_size=4, img_size=IMG, platforms=("cpu",))
    art = A.load_serving_artifact(tmp_path / "art", device="cpu")
    assert art.meta["platforms"] == ["cpu"]
    assert art(_u8(4, 0))["prob1"].shape == (4,)
    with pytest.raises(ValueError, match="takes uint8"):
        art(_u8(2, 0))


# --------------------------------------------------------------------------
# kernel-mode artifacts
# --------------------------------------------------------------------------


KERNEL_CASES = [("fastserve", 4, False), ("lowlat", 1, False),
                ("lowlat", 1, True), ("batch_grid", 4, False)]
KERNEL_IDS = ["fastserve", "lowlat", "lowlat_int8", "batch_grid"]


@pytest.mark.parametrize("mode,b,int8", KERNEL_CASES, ids=KERNEL_IDS)
def test_kernel_mode_artifact_equals_live_serving_fn(foldable, tmp_path,
                                                     mode, b, int8):
    """Exported and loaded without a card: the operators' fake
    implementations give the trace its shapes, and on the CPU the loaded
    program runs the plain versions, as make_serving_fn(device="cpu")."""
    _jm, _v, tm = foldable
    meta = A.save_serving_artifact(tmp_path / mode, tm, mode=mode,
                                   batch_size=b, img_size=FOLD_IMG,
                                   int8_weights=int8, device="cpu")
    assert meta["platforms"] == ["cuda"] and meta["int8_weights"] == int8
    assert meta["compute_dtype"] == "bfloat16"
    prog = (tmp_path / mode / "serving.pt2").read_bytes()
    assert b"vsd." in prog or b"vsd::" in prog          # the operators
    art = A.load_serving_artifact(tmp_path / mode, device="cpu")
    live = tfast.make_serving_fn(tm, batch_size=b, mode=mode,
                                 int8_weights=int8, device="cpu")
    before = dict(_build.LAUNCHES)
    u8 = _u8(b, 20 + b, FOLD_IMG)
    got = art(u8)
    assert torch.equal(got["prob1"], live(u8).float())
    assert torch.equal(got["pred"], (got["prob1"] > 0.5).to(torch.int32))
    assert _build.LAUNCHES == before                   # plain on the CPU


@pytest.mark.parametrize("mode,b,int8", KERNEL_CASES[1:],
                         ids=KERNEL_IDS[1:])
def test_kernel_mode_packed_leaves_equal_jax(foldable, tmp_path, mode, b,
                                             int8):
    """The packs of a port artifact, byte for byte those of the JAX
    artifact exported from this CPU host (tests/test_artifact.py:93-146),
    read back through the port's codec."""
    jm, variables, tm = foldable
    jmeta = JA.save_serving_artifact(tmp_path / "jax", jm, variables,
                                     mode=mode, batch_size=b,
                                     img_size=FOLD_IMG, int8_weights=int8)
    A.save_serving_artifact(tmp_path / "port", tm, mode=mode, batch_size=b,
                            img_size=FOLD_IMG, int8_weights=int8,
                            device="cpu")
    want = A._load_weights(tmp_path / "jax" / "weights.npz",
                           jmeta["weights_spec"])
    got = A.load_serving_artifact(tmp_path / "port", device="cpu").weights
    keys = [k for k in PACKED if k in want]
    assert keys and keys == [k for k in PACKED if k in got]
    for k in keys:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        if k == "aux":
            # pos embed + the folded patch-embed bias, b - shift @ k: the
            # two packages sum that 48-term f32 dot product in other orders
            ulp = 2.0 ** (math.floor(math.log2(float(want[k].abs().max())))
                          - 23)
            assert float((got[k] - want[k]).abs().max()) <= 2 * ulp
            continue
        assert A._raw_bytes(got[k]).tobytes() == A._raw_bytes(
            want[k]).tobytes(), k


def test_int8_artifact_weights_are_smaller(foldable, tmp_path):
    _jm, _v, tm = foldable
    for name, int8 in (("bf16", False), ("int8", True)):
        A.save_serving_artifact(tmp_path / name, tm, mode="lowlat",
                                batch_size=1, img_size=FOLD_IMG,
                                int8_weights=int8, device="cpu")
    size = (tmp_path / "bf16" / "weights.npz").stat().st_size
    size8 = (tmp_path / "int8" / "weights.npz").stat().st_size
    assert size8 < size
    assert A.load_serving_artifact(tmp_path / "int8", device="cpu").meta[
        "int8_weights"] is True


def test_invalid_combinations_raise_the_jax_messages(vit, foldable):
    _jm, _v, tm = vit
    with pytest.raises(ValueError, match="concrete batch_size"):
        A.export_serving(tm, mode="fastserve", batch_size=None,
                         device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        A.export_serving(tm, mode="fastserve", batch_size=2,
                         platforms=("cpu",), device="cpu")
    with pytest.raises(ValueError, match="unknown serving mode"):
        A.export_serving(tm, mode="warp9", batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="int8_weights"):
        A.export_serving(tm, mode="batch_grid", batch_size=2,
                         int8_weights=True, device="cpu")
    with pytest.raises(ValueError, match="int8_weights"):
        A.export_serving(tm, mode="module", batch_size=2, int8_weights=True)
    for bad in (0.0, 1.0, -0.2, 1.5):
        with pytest.raises(ValueError, match="threshold"):
            A.export_serving(tm, mode="module", threshold=bad)
    with pytest.raises(ValueError, match="temperature"):
        A.export_serving(tm, mode="module", temperature=0.0)


def test_fleet_artifacts_name_the_roadmap_item(vit, module_art):
    """Fleet artifacts (tests/test_torch_sharded_serving.py runs them on
    two ranks): over a model axis the weights are replicated and the
    batch split over the data axis, as JAX's fleet program does; a fleet
    over a data mesh records the mesh and the per-rank batch; a
    single-device artifact refuses a mesh at load, as JAX's does."""
    from types import SimpleNamespace

    _jm, _v, tm = vit
    tp = SimpleNamespace(mesh_dim_names=("data", "model"),
                         mesh=torch.zeros(4, 2))
    _e, _w, meta = A.export_serving(tm, mode="module", batch_size=8,
                                    img_size=IMG, mesh=tp)
    assert meta["mesh"] == {"axis_names": ["data", "model"],
                            "shape": [4, 2]} and meta["batch_size"] == 8
    dp = SimpleNamespace(mesh_dim_names=("data", "model"),
                         mesh=torch.zeros(4, 1))
    exported, _w, meta = A.export_serving(tm, mode="module", batch_size=8,
                                          img_size=IMG, mesh=dp)
    assert meta["mesh"] == {"axis_names": ["data", "model"],
                            "shape": [4, 1]} and meta["batch_size"] == 8
    (_weights, batch), _ = exported.example_inputs
    assert batch.shape[0] == 2                   # 8 rows over 4 data ranks
    with pytest.raises(ValueError, match="single-device"):
        A.load_serving_artifact(module_art, mesh=dp, device="cpu")


# --------------------------------------------------------------------------
# the codec and the load-time refusals
# --------------------------------------------------------------------------


def test_weights_codec_preserves_dtypes_and_structure(tmp_path):
    tree = {
        "a": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
              "b": torch.tensor([1.5, -2.25])},
        "t": (torch.tensor([[7]], dtype=torch.int32),
              torch.tensor([0.5, 0.25], dtype=torch.float16)),
        "l": [torch.tensor([True, False]), torch.tensor(-3, torch.int8)
              if False else torch.tensor([-3, 4], dtype=torch.int8)],
        "s": torch.tensor(2.5),
    }
    spec = A._save_weights(tmp_path / "w.npz", tree)
    json.dumps(spec)                      # meta.json embeds it verbatim
    back = A._load_weights(tmp_path / "w.npz", spec)
    assert isinstance(back["t"], tuple) and isinstance(back["l"], list)
    flat_a = [tree["a"]["b"], tree["a"]["w"], *tree["l"], tree["s"],
              *tree["t"]]
    flat_b = [back["a"]["b"], back["a"]["w"], *back["l"], back["s"],
              *back["t"]]
    for want, got in zip(flat_a, flat_b):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_codec_reads_jax_leaves_of_every_dtype(tmp_path):
    """A JAX-written weights file (bf16 through ml_dtypes there) decodes
    here through torch.frombuffer, value for value."""
    tree = {"w": jnp.asarray(np.arange(6).reshape(2, 3), jnp.bfloat16),
            "q": jnp.asarray([-127, 5, 127], jnp.int8),
            "f": jnp.asarray([1.5, -2.25], jnp.float32)}
    spec = JA._save_weights(tmp_path / "w.npz", tree)
    back = A._load_weights(tmp_path / "w.npz", spec)
    for k, v in tree.items():
        np.testing.assert_array_equal(_np(back[k]),
                                      np.asarray(v, np.float32))


def test_corrupt_weights_and_unknown_version_are_refused(vit, tmp_path):
    _jm, _v, tm = vit
    A.save_serving_artifact(tmp_path / "art", tm, mode="module",
                            batch_size=2, img_size=IMG)
    wf = tmp_path / "art" / "weights.npz"
    good = wf.read_bytes()
    data = bytearray(good)
    data[len(data) // 2] ^= 0xFF
    wf.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        A.load_serving_artifact(tmp_path / "art", device="cpu")
    wf.write_bytes(good[:len(good) // 2])                    # truncated
    with pytest.raises(ValueError, match="corrupt"):
        A.load_serving_artifact(tmp_path / "art", device="cpu")
    wf.write_bytes(good)
    meta_path = tmp_path / "art" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["format_version"] = 99
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format 99"):
        A.load_serving_artifact(tmp_path / "art", device="cpu")


def test_jax_artifact_is_refused(vit, tmp_path):
    jm, variables, _tm = vit
    JA.save_serving_artifact(tmp_path / "jax", jm, variables, mode="module",
                             batch_size=2, img_size=IMG, platforms=("cpu",))
    with pytest.raises(ValueError, match="JAX artifact"):
        A.load_serving_artifact(tmp_path / "jax", device="cpu")


# --------------------------------------------------------------------------
# the verbs
# --------------------------------------------------------------------------


def _seeded_decode(path, size, resize="exact"):
    """Stands in for ``loader.decode_image`` (PIL may be absent): a frame
    from the file name."""
    seed = sum(map(ord, str(path)))
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                                dtype=np.uint8)


@pytest.fixture
def seeded_images(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "decode_image", _seeded_decode)
    root = tmp_path / "imgs"
    paths = []
    for sub in ("a", "b"):
        (root / sub).mkdir(parents=True)
        for i in range(3):
            p = root / sub / f"{i}.png"
            p.write_bytes(b"")
            paths.append(p)
    return root, sorted(paths)


def test_export_serving_then_predict(vit, tmp_path, seeded_images):
    """export-serving from a .pth (module mode, fixed batch 4) -> predict:
    the CSV equals score_records (the tail of 2 padded to the batch)."""
    jm, variables, tm = vit
    ckpt = tmp_path / "m.pth"
    tconvert.save_torch_checkpoint(str(ckpt), jax.tree.map(np.asarray,
                                                           variables))
    out = tmp_path / "art"
    tmain.main(["export-serving", str(ckpt), str(out), "--batch-size", "4",
                "--device", "cpu", *TINY_SET])
    art = A.load_serving_artifact(out, device="cpu")
    assert art.meta["batch_size"] == 4 and art.meta["model"] == "ViTAntiSpoof"
    root, paths = seeded_images
    records = [Record(path=str(p), label=-1) for p in paths]
    want = A.score_records(art, records, num_workers=2)
    assert want["prob1"].shape == (6,)
    direct = art(np.stack([_seeded_decode(p, IMG) for p in paths[:4]]))
    np.testing.assert_array_equal(want["prob1"][:4], _np(direct["prob1"]))

    csv_path = tmp_path / "scores.csv"
    rows = tpredict.main([str(out), str(root), "--output", str(csv_path),
                          "--num-workers", "2", "--device", "cpu"])
    assert [r[0] for r in rows] == [str(p) for p in paths]
    with open(csv_path) as fh:
        lines = list(csv.reader(fh))
    assert lines[0] == ["path", "prob_live", "pred"] and len(lines) == 7
    for (path, prob, pred), w, wp in zip(lines[1:], want["prob1"],
                                         want["pred"]):
        assert abs(float(prob) - float(w)) <= 1e-6 and int(pred) == wp


def test_predict_rejects_empty_and_missing(module_art, tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit):
        tpredict.main([str(module_art), str(tmp_path / "empty"),
                       "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        tpredict.main([str(module_art), str(tmp_path / "nowhere"),
                       "--device", "cpu"])


def test_export_serving_lowlat_int8_from_a_checkpoint(vit, tmp_path):
    """--mode lowlat --lowlat-int8 from a .pth, exported without a card,
    scores as the live int8 regime on the CPU."""
    jm, variables, tm = vit
    ckpt = tmp_path / "m.pth"
    tconvert.save_torch_checkpoint(str(ckpt), jax.tree.map(np.asarray,
                                                           variables))
    out = tmp_path / "art"
    texport.main([str(ckpt), str(out), "--mode", "lowlat", "--batch-size",
                  "1", "--lowlat-int8", "--threshold", "0.62", "--device",
                  "cpu", *TINY_SET])
    art = A.load_serving_artifact(out, device="cpu")
    assert art.meta["int8_weights"] and art.threshold == 0.62
    live = tfast.make_serving_fn(tm, batch_size=1, int8_weights=True,
                                 device="cpu")
    u8 = _u8(1, 5)
    assert torch.equal(art(u8)["prob1"], live(u8).float())


def test_export_serving_registry_model(tmp_path):
    """--model ResNet50_Pretrained in module mode (a torchvision-keyed
    .pth), against the registry model's live eval program; the JAX verb's
    refusals."""
    from vit_spoof_detection_pda_tpu_torch.models.registry import build_model

    sd = build_model("SigNet_F", seed=3, device="cpu").state_dict()
    pth = tmp_path / "rn.pth"
    torch.save(sd, pth)
    out = tmp_path / "rn_art"
    texport.main([str(pth), str(out), "--model", "ResNet50_Pretrained",
                  "--batch-size", "2", "--device", "cpu",
                  "--set", f"data.img_size={IMG}"])
    art = A.load_serving_artifact(out, device="cpu")
    assert art.meta["model"] == "ResNet50"
    module = build_model("ResNet50_Pretrained", pretrained_path=str(pth),
                         img_size=IMG, device="cpu")
    u8 = _u8(2, 4)
    got, want = art(u8), make_infer_fn(module)(torch.from_numpy(u8))
    np.testing.assert_allclose(_np(got["prob1"]), _np(want["prob1"]),
                               atol=MODULE_ATOL, rtol=0)
    x = str(tmp_path / "x")
    for argv in ([x, "--model", "Custom_ViT_FineTuned"],   # no checkpoint
                 [x, "--model", "Base_ViT_Pretrained"],    # no weight file
                 [x, "--model", "NopeNet"],                # unknown entry
                 [x],                                      # no --model
                 [x, "--model", "SigNet_F", "--batch-size", "1",
                  "--lowlat-int8"],                        # needs lowlat
                 [x, "--model", "SigNet_F", "--mode", "lowlat"],  # no batch
                 [x, "--model", "SigNet_F", "--threshold", "high"],
                 [x, "--model", "SigNet_F", "--threshold", "1.0"],
                 [x, "--model", "SigNet_F", "--threshold", "optimal"]):
        with pytest.raises(SystemExit):
            texport.main(argv + ["--device", "cpu"])


def test_serve_two_artifacts_and_serve_bench(vit, foldable, module_art,
                                             tmp_path, monkeypatch):
    """The serve verb over a module artifact and a lowlat one on port 0 in
    a thread; serve-bench against it; every answer equals the direct
    score of its frame."""
    from vit_spoof_detection_pda_tpu_torch.serve.loadgen import sample_frame

    started = {}

    def run_in_thread(server, warmup=True):
        server.batcher.warmup()
        started["server"] = server
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server

    monkeypatch.setattr(tserver, "run_server", run_in_thread)
    _jm, _v, tm = vit
    low = tmp_path / "low"
    A.save_serving_artifact(low, tm, mode="lowlat", batch_size=1,
                            img_size=IMG, int8_weights=True, device="cpu")
    tserve_cli.main([str(module_art), str(low), "--port", "0",
                     "--max-batch", "4", "--device", "cpu"])
    server = started["server"]
    try:
        assert sorted(server.batcher.batch_sizes) == [1, 2, 4]
        url = f"http://127.0.0.1:{server.server_address[1]}"
        out = tbench_cli.main([url, "--clients", "2", "--requests", "8",
                               "--img-size", str(IMG), "--warmup", "1"])
        assert out["errors"] == 0 and out["requests"] == 8
        frame = sample_frame(IMG)
        answers = []
        from vit_spoof_detection_pda_tpu_torch.serve.loadgen import run_load
        run_load(url, clients=1, requests=3, img_size=IMG, warmup=0,
                 answers=answers)
        want = A.load_serving_artifact(low, device="cpu")(frame[None])
        for a in answers:
            assert abs(a["prob_live"] - float(want["prob1"][0])) <= 1e-6
    finally:
        server.shutdown_clean()


def test_serve_rejects_what_jax_rejects(module_art):
    for argv in ([],                                          # neither
                 [str(module_art), "--checkpoint", "x"],       # both
                 [str(module_art), "--threshold", "0.7"],      # live only
                 [str(module_art), "--max-batch", "0"],
                 ["--checkpoint", "x", "--shapes", "a,b"]):
        with pytest.raises(SystemExit):
            tserve_cli.main(argv + ["--device", "cpu"])


def test_benchmark_device_latency_on_an_artifact(vit, tmp_path, capsys):
    _jm, _v, tm = vit
    A.save_serving_artifact(tmp_path / "art", tm, mode="module",
                            batch_size=4, img_size=IMG)
    out = tbench.main(["--device-latency", "--artifact",
                       str(tmp_path / "art"), "--n1", "2", "--batch-size",
                       "999", "--device", "cpu"])          # 999 overridden
    assert out["artifact_mode"] == "module"
    assert out["batch_size"] == 4 and out["ms_per_image"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(out))


def test_describe_artifacts_as_jax(vit, module_art, tmp_path):
    """describe reads the JAX package's artifacts with the JAX verb's
    keys and values (plus torch_version), and the port's with the same
    keys; --verify catches a truncated weights file."""
    jm, variables, _tm = vit
    JA.save_serving_artifact(tmp_path / "jax", jm, variables, mode="module",
                             batch_size=2, img_size=IMG, platforms=("cpu",))
    want = jdescribe.describe_path(str(tmp_path / "jax"), verify=True)
    got = tdescribe.describe_path(str(tmp_path / "jax"), verify=True)
    assert got == {**want, "torch_version": None}
    port = tdescribe.describe_path(str(module_art), verify=True)
    assert set(port) == set(got) and port["checksums_ok"] is True
    assert port["kind"] == "serving_artifact" and port["mode"] == "module"
    assert port["torch_version"] == torch.__version__
    wf = tmp_path / "jax" / "weights.npz"
    wf.write_bytes(wf.read_bytes()[:100])
    assert tdescribe.describe_path(str(tmp_path / "jax"),
                                   verify=True)["checksums_ok"] is False
