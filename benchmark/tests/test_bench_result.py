"""The result line and the runs that must print none."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.common import harness

from ._tiny import tiny_run

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_result_line_untraced(capsys):
    result = tiny_run("synth.fs2-espnet-v1.b16")
    harness.emit(result)
    line = _last_line(capsys)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line) == KEYS and line["correct"] is True
    assert set(line["metrics"]) == {"synth_audio_s_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_result_line_traced(capsys, monkeypatch):
    from benchmark.common import trace

    fake = trace.DeviceTrace(window_s=2.0, busy_s=1.5,
                             kernels={"mrf_conv_kernel": (18, 0.5), "gemm": (4, 1.0)},
                             gaps=[("synthesize", 0.3), ("outside any span", 0.2)])
    def start(self):
        if self.enabled:
            self._result = fake

    monkeypatch.setattr(trace.DeviceTracer, "start", start)
    cell = "synth.fs2-espnet-v1.b16"
    from ._tiny import tiny_cell
    import time

    import torch

    result = harness.run_cell(tiny_cell(cell), seed=3, seconds=1.0, trace=True,
                              device=torch.device("cpu"), t_process=time.perf_counter())
    harness.emit(result)
    line = _last_line(capsys)
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert set(line["metrics"]) <= set(harness.load_cell(cell).per_layer)
    assert {"idle.synth", "synth.forwards_per_batch", "mfu.synth"} <= set(line["metrics"])
    assert line["device"]["busy_s"] == 1.5 and line["device"]["window_s"] == 2.0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["device_ops"]) <= 10


def _run_py(cwd: Path, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "synth.fs2-espnet-v1.b16", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card")
    r = _run_py(ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 3 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_py(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and not r.stdout.strip().startswith("{")
