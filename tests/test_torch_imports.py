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
    for mod in ("models.fasttrain", "ops.ln_bwd", "ops.losses",
                "train.schedule", "train.state", "train.step") + LAZY_PIL:
        assert f"vit_spoof_detection_pda_tpu_torch.{mod}" in mods
    assert len(mods) >= 26


# the modules of the serving front, which the card's machine imports
# without PIL: they may import it inside a function only
LAZY_PIL = ("ops.lowlat", "data.loader", "serve.loadgen", "serve.server")


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
