"""The port's CLI takes the JAX CLI's flags.

The two CLIs have the same 13 commands. For each, every long option of the
JAX click command, with its ``--no-`` form, is an option of the port's
argparse sub-command; the port's extra ``--device`` is allowed. ``serve --no-use-ema --no-warmup --data-parallel 1`` parses, and
``serve --data-parallel 2 --device cpu`` and ``synthesize --data-parallel 2
--device cpu`` run on two CPU replicas and give what one replica gives;
``train --model-parallel 2`` without ``--distributed`` exits naming
torchrun, and ``--distributed`` outside a launcher's environment raises. Every
command that reads a config takes the YAML file ``helpers`` writes with
``yaml.safe_dump`` and builds the config its JSON twin gives, and a relative
``training.vocoder_path`` resolves as the JAX loader resolves it."""

import argparse
import io
import json
import urllib.request

import click
import numpy as np
import pytest
import torch
import yaml

from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu.config import load_config_base_command as j_load
from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.testing import get_stubbed_model, stub_config
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch import config as config_module
from fastspeech2_lightning_tpu_torch.serving.server import SynthesisServer
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

from helpers import make_training_workspace

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


def test_serve_data_parallel_above_1_raises_as_synthesize_does(tmp_path, monkeypatch):
    """Neither raises any more: ``serve --data-parallel 2 --device cpu``
    serves from two CPU replicas the one-replica Synthesizer's mel, and
    ``synthesize --data-parallel 2 --device cpu`` writes the spec files one
    replica writes (within JAX's data-parallel tolerance, 2e-5)."""
    torch.set_num_threads(2)
    _, orbax_dir = get_stubbed_model(tmp_path / "m", config=stub_config(dtype="float32"))
    model = export_reference_lightning_checkpoint(orbax_dir, tmp_path / "m.ckpt")
    texts = ["hello world", "the quick brown fox", "abc def"]
    specs = {}
    for dp in ("1", "2"):
        out = tmp_path / f"dp{dp}"
        cli.main(["synthesize", str(model), *[a for t in texts for a in ("-t", t)], "-O",
                  "spec", "-b", "2", "--data-parallel", dp, "--device", "cpu", "-o", str(out)])
        specs[dp] = {p.name: np.load(p) for p in sorted(out.glob("**/*.npy"))}
    assert list(specs["1"]) == list(specs["2"]) and len(specs["1"]) == len(texts)
    for name, want in specs["1"].items():
        np.testing.assert_allclose(specs["2"][name], want, rtol=0, atol=2e-5)

    servers = []
    monkeypatch.setattr(SynthesisServer, "serve_forever", lambda self: servers.append(self))
    cli.main(["serve", str(model), "--data-parallel", "2", "--device", "cpu", "--port", "0",
              "--max-frames", "128"])
    (srv,) = servers
    assert srv.synthesizer.devices == [torch.device("cpu")] * 2
    want = Synthesizer.from_checkpoint(model, max_frames=128, device="cpu").synthesize(
        texts[:1]).mels[0]
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://{srv.address[0]}:{srv.address[1]}/synthesize",
            data=json.dumps({"text": texts[0], "format": "mel"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            mel = np.load(io.BytesIO(resp.read()))
    finally:
        srv.shutdown()
    assert mel.shape == want.shape and mel.shape[0] > 0
    np.testing.assert_allclose(mel, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("flags", [["--model-parallel", "2"], ["--distributed"]])
def test_train_refuses_model_parallel_and_multi_host(tmp_path, flags, monkeypatch, capsys):
    """Both modes run (tests/test_torch_distributed_trainer.py); what is
    refused is a launch that cannot hold them: --model-parallel above 1 in
    one process exits naming torchrun, and --distributed outside a
    launcher's environment raises naming its variables."""
    config = tmp_path / "c.json"
    config.write_text("{}")
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                 "FS2T_COORDINATOR_ADDRESS", "FS2T_NUM_PROCESSES", "FS2T_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    if "--distributed" in flags:
        with pytest.raises(ValueError, match="FS2T_COORDINATOR_ADDRESS"):
            cli.main(["train", str(config), *flags, "--device", "cpu"])
    else:
        with pytest.raises(SystemExit) as exit_:
            cli.main(["train", str(config), *flags, "--device", "cpu"])
        assert exit_.value.code == 2 and "torchrun" in capsys.readouterr().err
    args = cli._parser().parse_args(["train", str(config), "--no-distributed",
                                     "--model-parallel", "1"])
    assert (args.distributed, args.model_parallel) == (False, 1)


CONFIG_COMMANDS = {"preprocess": [], "train": ["--device", "cpu"],
                   "train-vocoder": ["--device", "cpu"],
                   "evaluate-vocoder": ["-v", "VOCODER", "--device", "cpu"],
                   "benchmark": ["--device", "cpu"], "check-data": [], "doctor": []}


_LOAD = config_module.load_config_base_command


class _Loaded(Exception):
    """Stops a command once its config is built."""


@pytest.fixture(scope="module")
def yaml_workspace(tmp_path_factory):
    """helpers' workspace: its config.yaml (yaml.safe_dump) and a JSON twin."""
    root = tmp_path_factory.mktemp("yaml_cli")
    make_training_workspace(root, n_utts=4)
    twin = root / "config.json"
    twin.write_text(json.dumps(yaml.safe_load((root / "config.yaml").read_text())))
    (root / "voc.npz").write_bytes(b"")
    return root


def _config_of(command, path, root, monkeypatch):
    """The config `command` builds from `path`: the loader is wrapped to
    record it (and, but in doctor, which reports and goes on, to stop)."""
    seen = []

    def spy(config_file, config_args=None):
        seen.append(_LOAD(config_file, config_args))
        if command != "doctor":
            raise _Loaded
        return seen[-1]

    monkeypatch.setattr(config_module, "load_config_base_command", spy)
    argv = [command, str(path)] + [str(root / "voc.npz") if a == "VOCODER" else a
                                   for a in CONFIG_COMMANDS[command]]
    try:
        cli.main(argv)
    except (_Loaded, SystemExit):
        pass
    assert len(seen) == 1, command
    return seen[0]


@pytest.mark.parametrize("command", list(CONFIG_COMMANDS))
def test_every_config_command_takes_a_yaml_config(yaml_workspace, monkeypatch, command):
    root = yaml_workspace
    got = _config_of(command, root / "config.yaml", root, monkeypatch)
    want = _config_of(command, root / "config.json", root, monkeypatch)
    assert got == want
    assert got.training.batch_size == 2 and got.preprocessing.audio.n_mels == 20


def test_a_relative_vocoder_path_resolves_as_in_jax(tmp_path, monkeypatch):
    (tmp_path / "sub").mkdir()
    (tmp_path / "elsewhere").mkdir()
    path = tmp_path / "sub" / "config.yaml"
    path.write_text(yaml.safe_dump({"training": {"vocoder_path": "../vocoders/v.npz"}}))
    monkeypatch.chdir(tmp_path / "elsewhere")
    got = config_module.FastSpeech2Config.from_file(path).training.vocoder_path
    assert got == str(j_load(path).training.vocoder_path) == str(
        (tmp_path / "vocoders" / "v.npz").resolve())
    assert config_module.load_config_base_command(
        path, ["training.vocoder_path=v2.npz"]).training.vocoder_path == str(
        j_load(path, ["training.vocoder_path=v2.npz"]).training.vocoder_path)
    assert config_module.FastSpeech2Config.from_dict({}).training.vocoder_path is None
