"""The port's ``doctor`` against the JAX package's, on the CPU.

``check_config`` gives the JAX rows (names, statuses and messages) on the
same JSON configs: a preprocessed workspace, a missing ``save_dir``, an
incomplete one, a missing ``stats.json``, missing filelists, and a file that
does not parse. Here, with no card and no nvcc, ``run_doctor`` returns 1 with
the ``devices``, ``nvcc`` and every kernel row FAIL, and the CLI exits 1. A
probe that outlives its timeout becomes a FAIL row (the probe program
monkeypatched, as ``tests/test_doctor.py`` does), and so does a check that
raises."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from fastspeech2_lightning_tpu.cli import doctor as jdoctor
from fastspeech2_lightning_tpu_torch import doctor
from fastspeech2_lightning_tpu_torch.kernels import build

from helpers import make_training_workspace

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    jcfg = make_training_workspace(root, n_utts=4, batch_size=2, bucket_count=1)
    data = jcfg.model_checkpoint_dump()
    path = root / "config.json"
    path.write_text(json.dumps(data))
    return root, data


def _variant(workspace, name, edit):
    root, data = workspace
    data = json.loads(json.dumps(data))
    edit(root, data)
    path = root / f"{name}.json"
    path.write_text(json.dumps(data))
    return path


def _no_stats(root, data):
    pre = root / "pre_no_stats"
    if not pre.exists():
        shutil.copytree(root / "pre", pre)
        (pre / "stats.json").unlink()
    data["preprocessing"]["save_dir"] = str(pre)


def _incomplete(root, data):
    pre = root / "pre_incomplete"
    (pre / "audio").mkdir(parents=True, exist_ok=True)
    data["preprocessing"]["save_dir"] = str(pre)


VARIANTS = {
    "populated": lambda root, data: None,
    "missing_artifacts": lambda root, data: data["preprocessing"].update(
        save_dir=str(root / "nowhere")),
    "incomplete_artifacts": _incomplete,
    "missing_stats": _no_stats,
    "missing_filelists": lambda root, data: data["training"].update(
        training_filelist=str(root / "nope.psv"), validation_filelist="relative/nope.psv"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_check_config_rows_match_jax(workspace, variant):
    path = _variant(workspace, variant, VARIANTS[variant])
    got, want = doctor.check_config(path), jdoctor.check_config(path)
    assert got == [tuple(r) for r in want]
    statuses = {name: status for name, status, _ in got}
    assert statuses["config"] == doctor.OK
    if variant == "populated":
        assert set(statuses.values()) == {doctor.OK}


def test_check_config_unparseable_is_a_fail_row_in_both(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text("{ not json")
    got, want = doctor.check_config(path), jdoctor.check_config(path)
    assert [r[:2] for r in got] == [tuple(r[:2]) for r in want] == [("config", doctor.FAIL)]


def test_run_doctor_fails_here_without_card_or_nvcc(workspace):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    lines = []
    rc = doctor.run_doctor(workspace[0] / "config.json", device_timeout_s=120.0,
                           echo=lines.append)
    assert rc == 1
    rows = {line[2:16].strip(): line for line in lines[:-1]}
    assert rows["devices"].startswith("✗") and "no CUDA device" in rows["devices"]
    if shutil.which("nvcc") is None:
        assert rows["nvcc"].startswith("✗")
        for name in build.all_sources():
            assert lines[[i for i, line in enumerate(lines)
                          if line[2:].startswith(f"{name}.cu")][0]].startswith("✗")
    assert rows["versions"].startswith("✓") and "torch=" in rows["versions"]
    assert "jax" not in rows["versions"]
    assert rows["config"].startswith("✓") and rows["build-cache"].startswith("✓")
    n_fail = sum(line.startswith("✗") for line in lines[:-1])
    assert lines[-1] == f"{len(lines) - 1} checks: {n_fail} failed, 0 warnings"


def test_a_probe_past_its_timeout_is_a_fail_row(monkeypatch):
    monkeypatch.setattr(doctor, "_DEVICE_PROBE", "import time; time.sleep(60)")
    t0 = time.time()
    name, status, msg = doctor.probe_devices(timeout_s=1.0)
    assert time.time() - t0 < 30
    assert (name, status) == ("devices", doctor.FAIL) and "hung" in msg


def test_a_raising_check_is_a_fail_row(monkeypatch):
    def broken():
        raise ImportError("no module named scipy")

    monkeypatch.setattr(doctor, "check_versions", broken)
    monkeypatch.setattr(doctor, "probe_devices",
                        lambda timeout_s: ("devices", doctor.OK, "stubbed"))
    lines = []
    doctor.run_doctor(None, echo=lines.append)
    assert lines[0] == "✗ versions       ImportError: no module named scipy"
    assert any(line.startswith("✓ devices") for line in lines)


def test_cli_doctor_exits_1_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "doctor",
                          "--device-timeout", "120"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1, out.stderr
    assert "failed" in out.stdout.splitlines()[-1] and "✗ devices" in out.stdout
