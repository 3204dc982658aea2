"""The port and chip_smoke.py stand alone: neither imports JAX, flax or
the JAX package, and every module imports where none of those can."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "vit_spoof_detection_pda_tpu_torch"
FORBIDDEN = ("jax", "flax", "vit_spoof_detection_pda_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib, importlib.util\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_port_has_modules_to_check():
    mods = _modules()
    assert "vit_spoof_detection_pda_tpu_torch.models.fastserve" in mods
    assert "vit_spoof_detection_pda_tpu_torch.ops.attention" in mods
    for mod in ("models.fasttrain", "models.registry", "models.resnet",
                "metrics.parity", "eval.runner", "eval.single",
                "eval.harness", "ops.ln_bwd", "ops.losses",
                "train.schedule", "train.state", "train.step",
                "data.conventions", "augment") + LAZY_PIL:
        assert f"vit_spoof_detection_pda_tpu_torch.{mod}" in mods
    # the training loop's modules (the JAX-free copies among them)
    for mod in ("config", "train.trainer", "train.driver", "train.early_stop",
                "metrics.device", "utils", "utils.checkpoint",
                "utils.telemetry", "utils.determinism"):
        assert f"vit_spoof_detection_pda_tpu_torch.{mod}" in mods
    assert len(mods) >= 55


# the modules of the serving front and of the augmentation slice, which
# the card's machine imports without PIL: they may import it inside a
# function only
LAZY_PIL = ("ops.lowlat", "data.loader", "serve.loadgen", "serve.server",
            "ops.warp", "ops.augment", "ops.gather", "ops.nlm", "ops.image",
            "augment.policy", "augment.engine", "data.manifest",
            "train.online", "train.pool", "train.driver", "eval.runner", "eval.single", "eval.harness", "metrics.parity",
            "models.registry", "models.resnet")


@pytest.mark.parametrize("mod", LAZY_PIL)
def test_pil_is_imported_inside_functions_only(mod):
    path = PORT / (mod.replace(".", "/") + ".py")
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:                    # module-level statements
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            names = ([a.name for a in sub.names] if isinstance(sub, ast.Import)
                     else [sub.module or ""]
                     if isinstance(sub, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "PIL" for n in names), (
                f"{path.name}:{sub.lineno} imports PIL at module level")


def test_serving_modules_import_without_pil():
    mods = [f"vit_spoof_detection_pda_tpu_torch.{m}" for m in LAZY_PIL]
    code = ("import sys, importlib\n"
            f"for name in {FORBIDDEN + ('PIL',)!r}:\n"
            "    sys.modules[name] = None\n"
            f"for mod in {mods!r}:\n"
            "    importlib.import_module(mod)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# the eval slice writes its artifacts where the card's machine has neither
# pandas nor matplotlib (nor PIL: its faces come from elsewhere there)
EVAL_MODULES = ("eval", "eval.runner", "eval.single", "eval.harness",
                "metrics.parity", "models.registry", "models.resnet",
                "models.convert", "models.vit", "ops.attention")


def test_eval_slice_imports_without_pandas_matplotlib_or_pil():
    mods = [f"vit_spoof_detection_pda_tpu_torch.{m}" for m in EVAL_MODULES]
    code = ("import sys, importlib\n"
            f"for name in {FORBIDDEN + ('PIL', 'pandas', 'matplotlib', 'seaborn')!r}:\n"
            "    sys.modules[name] = None\n"
            f"for mod in {mods!r}:\n"
            "    importlib.import_module(mod)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("mod", EVAL_MODULES)
def test_eval_slice_has_no_module_level_pandas(mod):
    path = PORT / (mod.replace(".", "/") + ".py")
    if not path.exists():
        path = PORT / mod.replace(".", "/") / "__init__.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] == "pandas" for n in names), (
            f"{path.name}:{node.lineno} imports pandas")


# the parallel layer: imported by the Trainer, the eval runner and the
# model on every path, it must import where JAX and PIL cannot, and join
# no process group (nor start a process) while importing
PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.collectives",
                    "parallel.dryrun")


def test_parallel_modules_import_without_jax_or_pil():
    mods = [f"vit_spoof_detection_pda_tpu_torch.{m}"
            for m in PARALLEL_MODULES]
    assert set(mods) <= set(_modules())
    code = ("import sys, importlib\n"
            f"for name in {FORBIDDEN + ('PIL',)!r}:\n"
            "    sys.modules[name] = None\n"
            f"for mod in {mods!r}:\n"
            "    importlib.import_module(mod)\n"
            "import torch.distributed as dist, multiprocessing as mp\n"
            "assert not dist.is_initialized()\n"
            "assert not mp.active_children()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
