"""The port's CLI takes the JAX CLI's flags.

The two CLIs have the same 13 commands. For each, every long option of the
JAX click command, with its ``--no-`` form, is an option of the port's
argparse sub-command; the port's extra ``--device`` is allowed. ``serve --no-use-ema --no-warmup --data-parallel 1`` parses, and
``serve --data-parallel 2`` raises as ``synthesize --data-parallel 2``
does; ``train --model-parallel 2`` and ``--distributed`` raise too."""

import argparse

import click
import pytest

from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu_torch import cli

SHARED = ("average-checkpoints", "benchmark", "check-data", "convert-artifacts", "doctor",
          "evaluate-vocoder", "export-checkpoint", "export-serving", "preprocess", "serve",
          "synthesize", "train", "train-vocoder")


def _port_commands() -> dict:
    parser = cli._parser()
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _jax_long_options(name: str) -> set:
    options = set()
    for param in jax_app.commands[name].params:
        if isinstance(param, click.Option):
            options.update(o for o in param.opts + param.secondary_opts if o.startswith("--"))
    return options


def test_the_port_has_every_jax_command_but_export_serving():
    """The command sets are equal: export-serving, once the one JAX command
    the port lacked (the name keeps that history), is ported too."""
    assert sorted(jax_app.commands) == sorted(_port_commands()) == sorted(SHARED)


@pytest.mark.parametrize("command", SHARED)
def test_every_jax_long_option_is_accepted(command):
    port = set(_port_commands()[command]._option_string_actions)
    missing = _jax_long_options(command) - port
    assert not missing, f"{command}: the port lacks {sorted(missing)}"
    extra = {o for o in port if o.startswith("--")} - _jax_long_options(command) - {"--help"}
    assert extra <= {"--device", "--log-steps"}, f"{command}: extra options {sorted(extra)}"


def test_serve_takes_the_negated_flags_and_data_parallel():
    args = cli._parser().parse_args(["serve", "m.ckpt", "--no-use-ema", "--no-warmup",
                                     "--data-parallel", "1"])
    assert (args.use_ema, args.warmup, args.data_parallel) == (False, False, 1)
    args = cli._parser().parse_args(["serve", "m.ckpt", "--use-ema", "--warmup"])
    assert (args.use_ema, args.warmup, args.data_parallel) == (True, True, None)


def test_serve_data_parallel_above_1_raises_as_synthesize_does(tmp_path):
    model = tmp_path / "m.ckpt"
    model.write_bytes(b"")
    with pytest.raises(NotImplementedError) as serve_error:
        cli.main(["serve", str(model), "--data-parallel", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError) as synth_error:
        cli.main(["synthesize", str(model), "-t", "hi", "-O", "spec", "--data-parallel", "2",
                  "--device", "cpu"])
    assert str(serve_error.value) == str(synth_error.value)
    assert "data-parallel" in str(serve_error.value)


@pytest.mark.parametrize("flags", [["--model-parallel", "2"], ["--distributed"]])
def test_train_refuses_model_parallel_and_multi_host(tmp_path, flags):
    config = tmp_path / "c.json"
    config.write_text("{}")
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(["train", str(config), *flags, "--device", "cpu"])
    args = cli._parser().parse_args(["train", str(config), "--no-distributed",
                                     "--model-parallel", "1"])
    assert (args.distributed, args.model_parallel) == (False, 1)
