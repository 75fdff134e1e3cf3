"""A run with the timed path broken underneath reads ``correct`` false: the
harness's look for a card skipped, each cell run at a small size on the CPU
with the program at float32 (where a sound run agrees with the reference to
round-off), once sound and once for each fault the cell can have."""

from __future__ import annotations

import pytest

from ._tiny import tiny_run

CASES = [
    ("train.fs2-default.b48-k4", None, True),
    ("train.fs2-default.b48-k4", "frozen_step", False),
    ("train.fs2-default.b48-k4", "drop_half", False),
    ("train.fs2-default.b48-k4", "alter_loss", False),
    ("train.hifigan-v1.b16-f32", None, True),
    ("train.hifigan-v1.b16-f32", "frozen_step", False),
    ("train.hifigan-v1.b16-f32", "drop_half", False),
    ("train.hifigan-v1.b16-f32", "alter_loss", False),
    ("synth.fs2-espnet-v1.b16", None, True),
    ("synth.fs2-espnet-v1.b16", "alter_wav", False),
    ("synth.fs2-espnet-v1.b16", "alter_vocoder_input", False),
    ("synth.fs2-espnet-v1.b16", "stretch_durations", False),
    ("serve.fs2-espnet-v1.poisson", None, True),
    ("serve.fs2-espnet-v1.poisson", "alter_wav", False),
]


@pytest.mark.parametrize("cell,fault,correct", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f, _ in CASES])
def test_fault_reads_incorrect(cell, fault, correct):
    result = tiny_run(cell, fault=fault)
    assert result["correct"] is correct, result["checks"]
