"""The port's command line (``python -m vit_spoof_detection_pda_tpu_torch
<verb>``) against the JAX package's, on the CPU:

- ``config`` prints the same bytes for the presets, ``--set`` overrides,
  ``--diff`` and ``PAD_*`` environment overrides;
- the command map names every JAX verb, every one ported; the ``--help``
  of ``analyze``, ``demo`` and the serving verbs exits 0;
  a verb that computes exits non-zero before it
  loads a model or data when it asks for the card and none is present;
- ``benchmark``: the same argv gives ``SystemExit`` in both CLIs for
  every ``parser.error`` rule, and tiny runs on the CPU (``--artifact``
  and ``--lowlat-int8`` among them) print JSON with the JAX verb's keys;
- ``describe`` of a ``.pth`` and of a serving-artifact descriptor: the
  same keys and values as JAX's (the artifact's plus ``torch_version``);
- ``utils/profiling.py``: ``profile_trace`` writes a trace.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from vit_spoof_detection_pda_tpu import __main__ as jmain
from vit_spoof_detection_pda_tpu.cli import benchmark as jbench
from vit_spoof_detection_pda_tpu.cli import config_cmd as jconfig
from vit_spoof_detection_pda_tpu.cli import describe as jdescribe
from vit_spoof_detection_pda_tpu.models import convert as jconvert
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch import __main__ as tmain
from vit_spoof_detection_pda_tpu_torch.cli import benchmark as tbench
from vit_spoof_detection_pda_tpu_torch.cli import config_cmd as tconfig
from vit_spoof_detection_pda_tpu_torch.cli import describe as tdescribe
from vit_spoof_detection_pda_tpu_torch.utils import profiling


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _printed(capsys, main, argv):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "simple-train"],
    ["--preset", "test"],
    ["--preset", "augment"],
    ["--preset", "evaluate-all"],
    ["--set", "optim.learning_rate=1e-5", "--set", "model.dropout=0.2",
     "--set", 'data.data_root="/data/aug"', "--set", "eval.thresholds=[0.3]"],
    ["--diff"],
    ["--preset", "test", "--diff", "--set", "eval.batch_size=64",
     "--set", "train_aug.color_jitter=[0.1,0.1,0.1,0.05]"],
])
@pytest.mark.parametrize("env", [{}, {"PAD_OPTIM__NUM_EPOCHS": "7",
                                      "PAD_MODEL__GELU": "tanh"}])
def test_config_prints_the_same_bytes(capsys, monkeypatch, argv, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = _printed(capsys, jconfig.main, argv)
    got = _printed(capsys, tconfig.main, argv)
    assert got == want
    assert got.strip()


def test_config_from_json_file_prints_the_same_bytes(capsys, tmp_path):
    from vit_spoof_detection_pda_tpu_torch.config import Config
    path = tmp_path / "cfg.json"
    path.write_text(Config().with_overrides(
        {"optim.weight_decay": 0.01, "data.batch_size": 64}).to_json())
    for extra in ([], ["--diff"]):
        argv = ["--config", str(path), *extra]
        assert (_printed(capsys, tconfig.main, argv)
                == _printed(capsys, jconfig.main, argv))


def test_command_map_names_every_jax_verb():
    assert list(tmain.COMMANDS) == list(jmain.COMMANDS)
    ported = {v for v, m in tmain.COMMANDS.items() if m}
    assert ported == {"augment", "train", "test", "evaluate-all",
                      "analyze", "benchmark", "export", "export-serving",
                      "predict", "serve", "serve-bench", "describe", "config",
                      "doctor", "demo"}
    assert not hasattr(tmain, "NOT_PORTED")


@pytest.mark.parametrize("verb,item", [
    ("analyze", "Queue 1 item 10"), ("demo", "Queue 1 item 10")])
def test_unported_verbs_exit_2_naming_their_item(capsys, verb, item):
    """The verbs item 10 brought: ``--help`` prints their usage and exits
    0, as every ported verb's does."""
    with pytest.raises(SystemExit) as exc:
        tmain.main([verb, "--help"])
    assert exc.value.code == 0
    captured = capsys.readouterr()
    assert "usage" in captured.out and captured.err == ""


@pytest.mark.parametrize("verb", ["export-serving", "predict", "serve",
                                  "serve-bench"])
def test_serving_verbs_help_exits_0(capsys, verb):
    with pytest.raises(SystemExit) as e:
        tmain.main([verb, "--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out


def test_dispatcher_help_and_unknown(capsys):
    assert tmain.main([]) == 1
    assert tmain.main(["--help"]) == 0
    assert tmain.main(["bogus"]) == 1
    assert "usage" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["train"], ["test"], ["evaluate-all"], ["augment"], ["benchmark"],
    ["benchmark", "--train-step"],
    ["benchmark", "--device-latency", "--lowlat"],
    ["test", "--fastserve"], ["train", "--device", "cuda"],
])
def test_computing_verbs_exit_before_loading_without_a_card(
        no_card, monkeypatch, argv):
    """No card and no --device cpu: SystemExit with a message, before any
    model, checkpoint, dataset or training run is touched."""
    def touched(*a, **k):
        raise AssertionError("loaded something before the device check")

    from vit_spoof_detection_pda_tpu_torch.cli import (augment, evaluate_all,
                                                       test, train)
    for mod, name in ((train, "train_from_config"), (test, "build_model"),
                      (test, "scan_test"), (evaluate_all, "scan_test"),
                      (augment, "scan_raw"), (tbench, "build_model"),
                      (tbench, "benchmark_throughput")):
        monkeypatch.setattr(mod, name, touched)
    with pytest.raises(SystemExit) as e:
        tmain.main(argv)
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


def test_interpret_with_device_cuda_is_a_parser_error(capsys):
    with pytest.raises(SystemExit) as e:
        tmain.main(["test", "--interpret", "--device", "cuda"])
    assert e.value.code == 2
    assert "--interpret" in capsys.readouterr().err


# every parser.error rule of the JAX benchmark verb (cli/benchmark.py:99-163)
BENCH_ERRORS = [
    ["--train-step", "--device-latency"],
    ["--train-step", "--fastserve"],
    ["--train-step", "--all-models"],
    ["--train-step", "--artifact", "x"],
    ["--train-step", "--model", "ResNet50_Pretrained"],
    ["--no-fused-forward"],
    ["--all-models"],
    ["--all-models", "--device-latency", "--fastserve"],
    ["--all-models", "--device-latency", "--lowlat"],
    ["--lowlat"],
    ["--lowlat-batch-grid"],
    ["--lowlat-int8"],
    ["--device-latency", "--lowlat", "--lowlat-int8", "--lowlat-batch-grid"],
    ["--device-latency", "--lowlat", "--lowlat-batch-grid",
     "--lowlat-encoder-only"],
    ["--artifact", "x"],
    ["--device-latency", "--artifact", "x", "--fastserve"],
    ["--device-latency", "--artifact", "x", "--iters", "3"],
    ["--device-latency", "--artifact", "x", "--interpret"],
]


@pytest.mark.parametrize("argv", BENCH_ERRORS)
def test_benchmark_rejects_what_jax_rejects(argv, capsys):
    with pytest.raises(SystemExit) as je:
        jbench.main(argv)
    with pytest.raises(SystemExit) as te:
        tbench.main(argv)
    assert je.value.code not in (0, None)
    assert te.value.code == 2            # the port: a parser error


@pytest.mark.parametrize("mode", ["artifact", "lowlat_int8"])
def test_benchmark_artifact_and_int8_modes_run(mode, tmp_path, capsys):
    """--artifact times a frozen program (a module artifact of a tiny ViT,
    whose fixed batch overrides --batch-size) and --lowlat-int8 the int8
    stream, here on the plain versions."""
    if mode == "artifact":
        from vit_spoof_detection_pda_tpu_torch.models import artifact
        from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof
        torch.manual_seed(0)
        model = ViTAntiSpoof(patch_size=16, embed_dim=64, depth=1,
                             num_heads=2, hidden=16, img_size=32).eval()
        artifact.save_serving_artifact(tmp_path / "art", model, batch_size=3,
                                       img_size=32)
        argv = ["--device-latency", "--artifact", str(tmp_path / "art"),
                "--n1", "1", "--device", "cpu"]
    else:
        argv = ["--device-latency", "--lowlat", "--lowlat-int8", "--n1", "1",
                "--batch-size", "1", "--device", "cpu", "--set",
                "data.img_size=32"]
    out = tbench.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert LATENCY_KEYS <= set(line) and line["device"] == "cpu"
    assert line["batch_size"] == (3 if mode == "artifact" else 1)
    if mode == "artifact":
        assert line["artifact_mode"] == "module"


TINY = ["--device", "cpu", "--batch-size", "2", "--set", "data.img_size=32"]
THROUGHPUT_KEYS = {"batch_size", "ms_per_batch", "images_per_second",
                   "achieved_tflops"}
LATENCY_KEYS = {"batch_size", "ms_per_exec", "ms_per_image",
                "images_per_second"}
TRAIN_KEYS = {"batch_size", "fused_forward", "gelu", "ms_per_step",
              "images_per_second", "achieved_tflops"}


@pytest.mark.parametrize("extra,keys", [
    (["--iters", "1"], THROUGHPUT_KEYS),
    (["--iters", "1", "--fastserve"], THROUGHPUT_KEYS),
    (["--device-latency", "--n1", "1"], LATENCY_KEYS),
    (["--device-latency", "--n1", "2", "--loop-iters", "2"],
     LATENCY_KEYS | {"loop_iters", "dispatch_free"}),
    (["--device-latency", "--n1", "1", "--fastserve"], LATENCY_KEYS),
    (["--train-step", "--iters", "1"], TRAIN_KEYS),
    (["--train-step", "--iters", "1", "--no-fused-forward"], TRAIN_KEYS),
], ids=["throughput", "throughput_fastserve", "latency", "latency_loop",
        "latency_fastserve", "train_step", "train_step_module"])
def test_benchmark_tiny_runs_print_jax_keys(capsys, extra, keys):
    out = tbench.main(TINY + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert set(line) == keys | {"device"}
    assert line["device"] == "cpu" and line["batch_size"] == 2


def test_benchmark_throughput_keys_match_a_jax_run(capsys):
    """The JAX verb's own output on the same argv (its CPU backend)."""
    argv = ["--batch-size", "2", "--iters", "1", "--set", "data.img_size=32"]
    jout = jbench.main(argv)
    tout = tbench.main(argv + ["--device", "cpu"])
    assert set(tout) == set(jout) | {"device"}


def test_describe_pth_matches_jax(tmp_path):
    variables = jvit.ViTAntiSpoof(depth=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    path = tmp_path / "m.pth"
    jconvert.save_torch_checkpoint(str(path), variables, epoch=4,
                                   metrics={"val_f1": 0.75, "auc": 0.5},
                                   config={"model_name": "vit"})
    assert tdescribe.describe_path(str(path)) == jdescribe.describe_path(
        str(path))
    bare = tmp_path / "bare.pth"
    torch.save({"w": torch.zeros(3, 2)}, bare)
    assert tdescribe.describe_path(str(bare)) == jdescribe.describe_path(
        str(bare))


def test_describe_reads_a_serving_artifact(tmp_path, capsys):
    """A bare descriptor (no weights spec, no files): the JAX verb's
    census of what there is, plus the port's torch_version key."""
    art = tmp_path / "art"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps({"format_version": 1}))
    got = tdescribe.main([str(art)])
    assert got == [{**jdescribe.describe_path(str(art)),
                    "torch_version": None}]
    assert "serving artifact" in capsys.readouterr().out


def test_profile_trace_writes_a_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "t")):
        with profiling.annotate("region"):
            torch.ones(4) @ torch.ones(4)
    trace = tmp_path / "t" / "trace.json"
    assert trace.stat().st_size > 0
    assert "region" in trace.read_text()
    with profiling.profile_trace(None):           # a no-op
        pass
    assert profiling.device_memory_gb() is None or torch.cuda.is_available()


def test_train_state_from_the_module_has_contiguous_leaves():
    """The train verb starts from the module's own weights; the converter
    returns the [in, out] matrices as transposed views, and the card's
    kernels refuse non-contiguous operands, so the state's leaves must be
    contiguous copies."""
    from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof
    from vit_spoof_detection_pda_tpu_torch.train.state import (
        create_train_state, make_optimizer, tree_flatten)
    state = create_train_state(ViTAntiSpoof(depth=1), make_optimizer(1e-3),
                               device="cpu")
    leaves, _ = tree_flatten(state.params)
    assert all(leaf.is_contiguous() for leaf in leaves)
