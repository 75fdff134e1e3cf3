"""The controls: the plain reference put in the program's place in the
nearest lower precision must read as not correct under each cell's limits
(the vocoder cell's control is the program's own bfloat16 path). On the CPU
at a small size with the cells' own limits; on a card at the cells' own
sizes on three seeds (``-m gpu``)."""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

import pytest
import torch

from benchmark.common import harness

from ._tiny import tiny_cell

CONTROLS = [("train.fs2-default.b48-k4", "fp8"), ("train.hifigan-v1.b16-f32", "program-bfloat16"),
            ("synth.fs2-espnet-v1.b16", "fp8"), ("serve.fs2-espnet-v1.poisson", "fp8")]


def control_checks(cell, mode: str, seed: int, device) -> list:
    driver = harness.load_module("traffic", cell.traffic)
    workdir = Path(tempfile.mkdtemp(prefix="fs2control-"))
    try:
        return driver.control(harness.Run(cell, seed, 0.0, False, device, time.perf_counter(),
                                          workdir), mode)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


@pytest.mark.parametrize("name,mode", CONTROLS, ids=[c for c, _ in CONTROLS])
def test_control_fails_on_the_cpu(name, mode):
    cell = tiny_cell(name)
    limits = harness.load_cell(name).params["limits"]
    cell.params["limits"] = limits
    checks = control_checks(cell, mode, 5, torch.device("cpu"))
    assert not all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name,mode", CONTROLS, ids=[c for c, _ in CONTROLS])
def test_control_fails_on_the_card(card, name, mode):
    for seed in (101, 102, 103):
        checks = control_checks(harness.load_cell(name), mode, seed, card)
        assert not all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]
