"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from padbench.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "vit_spoof_detection_pda_tpu"}
PROGRAM = "vit_spoof_detection_pda_tpu_torch"


def _top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _run_files():
    root = REPO / "padbench"
    return [p for p in root.rglob("*.py") if "tests" not in p.parts]


def test_no_jax_in_any_file_the_run_imports():
    files = _run_files()
    assert files
    for path in files:
        bad = _top_level_imports(path) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "padbench" / "reference").rglob("*.py"):
        names = _top_level_imports(path)
        assert PROGRAM not in names and not names & FORBIDDEN, path
        assert "padbench" not in names, path


def test_loading_every_driver_and_metric_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from padbench.harness import Manifest\n"
        "m = Manifest(%r)\n"
        "for c in m.cells: m.driver(m.workload(c)['driver'])\n"
        "for x in m.bench['per_layer']: m.reader(x['name'])\n"
        "import padbench.limits, padbench.run\n"
        "import vit_spoof_detection_pda_tpu_torch.eval.runner\n"
        "import vit_spoof_detection_pda_tpu_torch.serve.server\n"
        "import vit_spoof_detection_pda_tpu_torch.train.step\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & %r))\n"
        % (str(REPO), str(REPO), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    """Without a card: a non-zero exit and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "padbench/run.py", "--workload",
         "score.vit_b16_mlp_head.b128", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
