"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fastspeech2_lightning_tpu"}
PORT = "fastspeech2_lightning_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf8"))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert PORT not in top_level_imports(path)
    text = path.read_text(encoding="utf8")
    assert "from benchmark.common" not in text and "from ..common" not in text


def test_cell_setup_loads_no_jax():
    """A cell's set-up up to the device check, and every module of the port
    its drivers import, leave no JAX module loaded."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import run\n"
        "from benchmark.common import harness\n"
        "for c in ('train.fs2-default.b48-k4', 'train.hifigan-v1.b16-f32',\n"
        "          'serve.fs2-espnet-v1.poisson', 'synth.fs2-espnet-v1.b16'):\n"
        "    harness.load_module('traffic', harness.load_cell(c).traffic)\n"
        "import fastspeech2_lightning_tpu_torch.training.loop\n"
        "import fastspeech2_lightning_tpu_torch.training.vocoder\n"
        "import fastspeech2_lightning_tpu_torch.serving.server\n"
        "import fastspeech2_lightning_tpu_torch.synthesis.api\n"
        "rc = run.main(['--workload', 'synth.fs2-espnet-v1.b16', '--seed', '1',\n"
        "               '--seconds', '1', '--trace', '0'])\n"
        "print('FOUND', run.forbidden_modules(), rc)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env=env, timeout=300)
    assert "FOUND [] 3" in r.stdout, r.stdout + r.stderr
