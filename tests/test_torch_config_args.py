"""``-c/--config-args`` on the port's ``train``, ``synthesize``,
``train-vocoder`` and ``evaluate-vocoder``, as the JAX commands take it: the
overrides reach the config each command runs with, with the values the JAX
package's ``load_config_base_command`` gives (``synthesize`` applies them to
the checkpoint's config). The commands' work is replaced by a recorder."""

import contextlib
import io
import json

import pytest

from fastspeech2_lightning_tpu.config import load_config_base_command as j_load
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.text import TextProcessor

OVERRIDES = ["-c", "training.batch_size=3", "-c", "training.early_stopping.metric=mae",
             "-c", "model.use_postnet=no", "-c", "preprocessing.audio.f_max=7600",
             "-c", "training.optimizer.betas=[0.8, 0.99]"]


def _values(config: dict) -> tuple:
    t = config["training"]
    return (t["batch_size"], t["early_stopping"]["metric"], config["model"]["use_postnet"],
            config["preprocessing"]["audio"]["f_max"], list(t["optimizer"]["betas"]))


WANT = (3, "mae", False, 7600, [0.8, 0.99])


def _run(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        try:
            cli.main(argv)
        except SystemExit as e:
            return e.code, err.getvalue()
    return 0, err.getvalue()


@pytest.fixture
def config_file(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"preprocessing": {"save_dir": "pre"},
                                "training": {"batch_size": 2}}))
    return path


def test_train(monkeypatch, config_file):
    seen = []

    class Recorder:
        ckpt_path = None

        def __init__(self, config, device=None):
            seen.append(config)

        def fit(self, max_steps=None, resume=True):
            return []

    monkeypatch.setattr("fastspeech2_lightning_tpu_torch.training.loop.Trainer", Recorder)
    assert _run(["train", str(config_file), "--device", "cpu", *OVERRIDES])[0] == 0
    assert _values(seen[0].to_dict()) == WANT
    assert _values(j_load(config_file, OVERRIDES[1::2]).model_checkpoint_dump()) == WANT
    assert seen[0].preprocessing.save_dir == str(config_file.parent / "pre")


def test_train_vocoder(monkeypatch, config_file):
    seen = []
    monkeypatch.setattr("fastspeech2_lightning_tpu_torch.training.vocoder.train_vocoder",
                        lambda config, **kw: seen.append(config))
    assert _run(["train-vocoder", str(config_file), "--device", "cpu", *OVERRIDES])[0] == 0
    assert _values(seen[0].to_dict()) == WANT


def test_evaluate_vocoder(monkeypatch, config_file):
    seen = []
    monkeypatch.setattr("fastspeech2_lightning_tpu_torch.evaluation.evaluate_vocoder",
                        lambda config, path, **kw: seen.append(config) or {})
    (config_file.parent / "voc.npz").write_bytes(b"")
    code, _ = _run(["evaluate-vocoder", str(config_file), "-v",
                    str(config_file.parent / "voc.npz"), "--device", "cpu", *OVERRIDES])
    assert code == 0
    assert _values(seen[0].to_dict()) == WANT


def test_synthesize(monkeypatch, tmp_path):
    cfg = {"model": {"encoder": {"layers": 1, "heads": 2, "input_dim": 32,
                                 "feedforward_dim": 64},
                     "decoder": {"layers": 1, "heads": 2, "input_dim": 32,
                                 "feedforward_dim": 64},
                     "variance_predictors": {k: {"input_dim": 32, "n_layers": 1, "n_bins": 16}
                                             for k in ("energy", "pitch", "duration")}},
           "preprocessing": {"audio": {"n_mels": 20}},
           "text": {"symbols": {"letters": list("abc")}}}
    config = FastSpeech2Config.from_dict(cfg)
    model = FastSpeech2(config, n_symbols=len(TextProcessor(config.text).symbols))
    si = dict(min=-1.0, max=1.0, std=1.0, mean=0.0, norm_min=-1.0, norm_max=1.0)
    ckpt = write_checkpoint(tmp_path / "m.ckpt", model.state_dict(), cfg,
                            {"pitch": si, "energy": si})
    seen = []
    monkeypatch.setattr("fastspeech2_lightning_tpu_torch.synthesis.synthesize.synthesize_items",
                        lambda items, model, config, *a, **kw: seen.append(config))
    code, err = _run(["synthesize", str(ckpt), "-t", "abc", "-O", "spec", "-o",
                      str(tmp_path / "out"), "--device", "cpu", *OVERRIDES])
    assert code == 0, err
    assert _values(seen[0].to_dict()) == WANT
    code, err = _run(["synthesize", str(ckpt), "-t", "abc", "-O", "spec", "-o",
                      str(tmp_path / "out"), "--device", "cpu", "-c", "model.x={a: 1}"])
    assert code == 2 and "--config-args" in err
