"""The port's typed exceptions against the JAX package's, on the CPU.

A tiny corpus the JAX package preprocessed, read with
``model.learn_alignment=false``: without ``duration.npy`` files both
datasets raise ``InvalidConfiguration``, and with durations that do not sum
to the mel's frames both raise ``BadDataError``, each with the JAX
message. The port's classes are its own copies (``exceptions.py``), not the
JAX package's; the trainer's ``TrainingDivergedError`` is that class, and a
non-finite loss raises it with the JAX trainer's message."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu import exceptions as jexc
from fastspeech2_lightning_tpu.config import FastSpeech2Config as JConfig
from fastspeech2_lightning_tpu.dataset import load_datasets as j_load_datasets
from fastspeech2_lightning_tpu.text import lookuptables_from_config as j_lookups
from fastspeech2_lightning_tpu.training.loop import _guard_finite_losses as j_guard_finite_losses
from fastspeech2_lightning_tpu_torch import exceptions
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.dataset import load_datasets
from fastspeech2_lightning_tpu_torch.text.lookups import lookuptables_from_config
from fastspeech2_lightning_tpu_torch.training import loop
from fastspeech2_lightning_tpu_torch.training.loop import Trainer, TrainingDivergedError

from helpers import make_training_workspace

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(the preprocessed folder, the JAX config and the port's) of a
    learned-alignment corpus, read without learned alignment."""
    root = tmp_path_factory.mktemp("ws")
    jcfg = make_training_workspace(root, n_utts=3, batch_size=2)
    data = jcfg.model_checkpoint_dump()
    data["model"]["learn_alignment"] = False
    path = root / "config_no_alignment.json"
    path.write_text(json.dumps(data))
    return (Path(jcfg.preprocessing.save_dir), JConfig.load_config_from_path(path),
            FastSpeech2Config.from_file(path))


def _first_items(jcfg, cfg):
    """Item 0 of the JAX training dataset and of the port's, each as the
    exception it raises."""
    out = []
    for load in (lambda: j_load_datasets(jcfg, *j_lookups(jcfg))[0][0],
                 lambda: load_datasets(cfg, *lookuptables_from_config(cfg))[0][0]):
        with pytest.raises(Exception) as info:
            load()
        out.append(info.value)
    return out


def test_classes_are_the_ports_own_copies():
    for name in ("BadDataError", "InvalidConfiguration", "TrainingDivergedError"):
        mine, theirs = getattr(exceptions, name), getattr(jexc, name)
        assert mine is not theirs and mine.__module__ == exceptions.__name__
        assert mine.__mro__[1:] == theirs.__mro__[1:] == (Exception, BaseException, object)
    assert loop.TrainingDivergedError is exceptions.TrainingDivergedError


def test_missing_durations_raise_invalid_configuration(corpus):
    pre, jcfg, cfg = corpus
    assert not (pre / "duration").exists()
    jerr, err = _first_items(jcfg, cfg)
    assert type(jerr) is jexc.InvalidConfiguration
    assert type(err) is exceptions.InvalidConfiguration
    assert str(err) == str(jerr)
    assert "model.learn_alignment = false" in str(err)
    assert isinstance(err.__cause__, FileNotFoundError)


def test_durations_that_miss_the_frames_raise_bad_data(corpus):
    pre, jcfg, cfg = corpus
    (pre / "duration").mkdir()
    try:
        rng = np.random.default_rng(0)
        for spec in sorted((pre / "spec").glob("*.npy")):
            frames = np.load(spec).shape[1]
            name = spec.name.split("--")[:3] + ["duration.npy"]
            durations = rng.multinomial(frames + 3, [0.2] * 5).astype(np.int32)
            np.save(pre / "duration" / "--".join(name), durations)
        jerr, err = _first_items(jcfg, cfg)
    finally:
        for f in (pre / "duration").glob("*"):
            f.unlink()
        (pre / "duration").rmdir()
    assert type(jerr) is jexc.BadDataError and type(err) is exceptions.BadDataError
    assert str(err) == str(jerr)
    assert str(err).startswith("Something failed with the following items, please check "
                               "them for errors: ['")
    assert "durations sum to" in str(err)


def test_a_non_finite_loss_raises_the_jax_message(corpus, tmp_path):
    pre, jcfg, cfg = corpus
    data = cfg.to_dict()
    data["model"]["learn_alignment"] = True
    data["training"]["logger"]["save_dir"] = str(tmp_path)
    trainer = Trainer(FastSpeech2Config.from_dict(data), device="cpu")
    host = {"total": float("nan"), "spec": 1.0}
    with pytest.raises(TrainingDivergedError) as info:
        trainer._guard_finite(host, 7)
    with pytest.raises(jexc.TrainingDivergedError) as jinfo:
        j_guard_finite_losses(host, 7, True)
    assert str(info.value) == str(jinfo.value)
    assert "resume from the last good checkpoint" in str(info.value)
    data["training"]["halt_on_non_finite"] = False
    Trainer(FastSpeech2Config.from_dict(data), device="cpu")._guard_finite(host, 7)
