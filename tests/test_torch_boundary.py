"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fastspeech2_lightning_tpu_torch as port
from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.text import TextProcessor

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "fastspeech2_lightning_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pydantic", "yaml", "packaging",
             "fastspeech2_lightning_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."))


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter (this one already holds jax: tests/conftest.py)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split(".")[0] in FORBIDDEN and m.split(".")[0] != "fastspeech2_lightning_tpu_torch"]
    assert not bad, bad
    for module in ("serving.server", "training.loop", "training.step", "training.checkpoint",
                   "training.preemption", "dataset", "ops.mas", "ops.ctc", "ops.attention",
                   "synthesis.synthesize", "synthesis.writers", "synthesis.griffin_lim",
                   "preprocessing.features", "preprocessing.pipeline", "utils", "models.gst",
                   "synthesis.streaming", "text.g2p", "text.lexicon", "text.features",
                   "check_data", "preprocessing.f0", "preprocessing.priors",
                   "preprocessing.stats", "preprocessing.convert", "preprocessing.objective",
                   "utils.benchmarking", "doctor", "synthesis.exported"):
        assert f"fastspeech2_lightning_tpu_torch.{module}" in loaded


@pytest.mark.parametrize(
    "path", sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    + [REPO / "tools" / f"{name}_parent_timing.py" for name in ("ctc", "trainer")],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


@pytest.fixture
def tiny_ckpt(tmp_path):
    cfg = {
        "model": {
            "encoder": {"layers": 1, "heads": 2, "input_dim": 32, "feedforward_dim": 64},
            "decoder": {"layers": 1, "heads": 2, "input_dim": 32, "feedforward_dim": 64},
            "variance_predictors": {
                k: {"input_dim": 32, "n_layers": 1, "n_bins": 16}
                for k in ("energy", "pitch", "duration")
            },
        },
        "preprocessing": {"audio": {"n_mels": 20}},
        "text": {"symbols": {"letters": list("abc")}},
    }
    config = FastSpeech2Config.from_dict(cfg)
    model = FastSpeech2(config, n_symbols=len(TextProcessor(config.text).symbols))
    si = dict(min=-1.0, max=1.0, std=1.0, mean=0.0, norm_min=-1.0, norm_max=1.0)
    return write_checkpoint(tmp_path / "m.ckpt", model.state_dict(), cfg,
                            {"pitch": si, "energy": si})


def test_entry_points_refuse_to_fall_back_to_cpu(tiny_ckpt):
    from fastspeech2_lightning_tpu_torch.serving import serve
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer.from_checkpoint(tiny_ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(tiny_ckpt, port=0)
    syn = Synthesizer.from_checkpoint(tiny_ckpt, device="cpu")
    assert syn.device.type == "cpu"
    assert syn.synthesize(["abc"]).wavs is None


def test_cli_serve_refuses_without_card(tiny_ckpt):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "serve", str(tiny_ckpt),
         "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_cli_export_serving_refuses_without_card(tiny_ckpt, tmp_path):
    """The export runs on the card by default, and a cuda program set needs
    one even when the export runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for extra in ([], ["--device", "cpu", "--platforms", "cuda"]):
        out = subprocess.run(
            [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "export-serving",
             str(tiny_ckpt), "-o", str(tmp_path / "m.fs2x"), *extra],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0 and "no CUDA device" in out.stderr, extra
        assert not (tmp_path / "m.fs2x").exists()


def test_cli_train_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    (tmp_path / "pre").mkdir()
    (tmp_path / "pre" / "stats.json").write_text(json.dumps(
        {k: dict(min=-1.0, max=1.0, std=1.0, mean=0.0, norm_min=-1.0, norm_max=1.0)
         for k in ("pitch", "energy")}))
    (tmp_path / "config.json").write_text(json.dumps({"preprocessing": {"save_dir": "pre"}}))
    out = subprocess.run(
        [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "train",
         str(tmp_path / "config.json"), "--max-steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("command", ["train-vocoder", "evaluate-vocoder"])
def test_cli_vocoder_commands_refuse_without_card(tmp_path, command):
    """``train-vocoder`` and ``evaluate-vocoder`` refuse to run without a
    card unless given ``--device cpu``, as ``train`` does."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    (tmp_path / "config.json").write_text(json.dumps({"preprocessing": {"save_dir": "pre"}}))
    (tmp_path / "voc.npz").write_bytes(b"")
    extra = ["--max-steps", "1"] if command == "train-vocoder" else [
        "-v", str(tmp_path / "voc.npz")]
    out = subprocess.run(
        [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", command,
         str(tmp_path / "config.json"), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_cli_preprocess_on_device_refuses_without_card(tmp_path):
    """``preprocess --on-device-spec`` runs its spectral pass on the card
    unless given ``--device cpu``; it refuses before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    (tmp_path / "config.json").write_text(json.dumps({"preprocessing": {"save_dir": "pre"}}))
    base = [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "preprocess",
            str(tmp_path / "config.json")]
    out = subprocess.run(base + ["--on-device-spec"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "pre").exists()
    out = subprocess.run(base + ["--on-device-spec", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Preprocessed 0 training + 0 validation utterances" in out.stdout


def test_cli_check_data_scoring_refuses_without_card(tiny_ckpt, tmp_path):
    """``check-data --model-path`` scores on the card unless given
    ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    (tmp_path / "list.psv").write_text("basename|characters\nu0|abc\n")
    (tmp_path / "config.json").write_text(json.dumps({"preprocessing": {"save_dir": "pre"}}))
    out = subprocess.run(
        [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "check-data",
         str(tmp_path / "config.json"), "-f", str(tmp_path / "list.psv"),
         "--no-calculate-stats", "--model-path", str(tiny_ckpt), "-o", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not list((tmp_path / "out").glob("scores-*"))
