"""The port's ``check-data`` against the JAX package's, on the CPU.

A corpus of three utterances of different lengths and texts (one clipped),
preprocessed by the JAX package with its NumPy pitch golden. Both CLIs write
``checked-data.json`` with the cheap and with the thorough clipping counts
and ``--objective-evaluation`` (the reference-free estimates: torchaudio is
absent on both sides): every row within 1e-6. The coverage scores equal.
Then scoring: a stubbed JAX model (f32) exported to a Lightning .ckpt, its
teacher-forced losses through both CLIs' ``--model-path``: ``scores-0.psv``
in the same row order with every loss within 1e-4 relative (the MAS
durations are the same; the float32 forwards and the CTC scans differ in
rounding only), the coverage columns equal. Three utterances of three
(text pad, mel length) shapes keep the JAX compiles few."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import fastspeech2_lightning_tpu.native as jnative
from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu.cli.check_data import add_coverage_scores as j_add_coverage
from fastspeech2_lightning_tpu.config import FastSpeech2Config as JConfig
from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.preprocessing import Preprocessor as JPreprocessor
from fastspeech2_lightning_tpu.preprocessing.pipeline import save_wav
from fastspeech2_lightning_tpu.testing import get_stubbed_model
from fastspeech2_lightning_tpu.utils import write_filelist
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.check_data import add_coverage_scores, check_datapoint
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import Preprocessor
from fastspeech2_lightning_tpu_torch.utils import load_filelist

torch.set_num_threads(2)
SR = 22050
ROW_ATOL = 1e-6
LOSS_RTOL = 1e-4
TEXTS = ["abc dab", "a bad cab dad bead ace", "cede a bed"]
SECONDS = [0.55, 1.1, 0.8]


def _port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stderr(out), contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as e:
            return e.code, out.getvalue()
    return 0, out.getvalue()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("check")
    rng = np.random.default_rng(0)
    rows = []
    for i, (text, seconds) in enumerate(zip(TEXTS, SECONDS)):
        t = np.arange(int(seconds * SR)) / SR
        audio = 0.5 * np.sin(2 * np.pi * (140 + 50 * i) * t) + 0.02 * rng.standard_normal(len(t))
        if i == 1:
            audio = np.clip(1.6 * audio, -0.6, 0.6)  # flat rails
        save_wav(root / "wavs" / f"u{i}.wav", audio.astype(np.float32), SR)
        rows.append({"basename": f"u{i}", "characters": text, "speaker": "default",
                     "language": "default"})
    write_filelist(rows, root / "filelist.psv")
    tiny = {"layers": 1, "heads": 2, "input_dim": 32, "feedforward_dim": 64,
            "conv_kernel_size": 3}
    config = {
        "model": {"encoder": tiny, "decoder": tiny, "dtype": "float32", "max_mel_length": 128,
                  "variance_predictors": {k: {"input_dim": 32, "n_layers": 1, "n_bins": 16}
                                          for k in ("energy", "pitch", "duration")}},
        "preprocessing": {"save_dir": str(root / "pre"), "train_split": 0.67,
                          "audio": {"n_mels": 20},
                          "source_data": [{"data_dir": str(root / "wavs"),
                                           "filelist": str(root / "filelist.psv")}]},
        "text": {"symbols": {"letters": list("abcde")}},
        "training": {"batch_size": 2,
                     "training_filelist": str(root / "pre" / "training_filelist.psv"),
                     "validation_filelist": str(root / "pre" / "validation_filelist.psv")},
    }
    (root / "config.json").write_text(json.dumps(config))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        JPreprocessor(JConfig.load_config_from_path(root / "config.json")).run(cpus=1)
    jcfg = JConfig.load_config_from_path(root / "config.json")
    _, orbax_dir = get_stubbed_model(root / "model", config=jcfg)
    ckpt = export_reference_lightning_checkpoint(orbax_dir, root / "model.ckpt")
    return root, orbax_dir, ckpt


@pytest.fixture(scope="module", params=["cheap", "thorough"])
def checked(request, workspace):
    root = workspace[0]
    flags = ["--objective-evaluation"] + (
        ["--clip-detection"] if request.param == "thorough" else [])
    out_j, out_p = root / f"jax-{request.param}", root / f"port-{request.param}"
    res = CliRunner().invoke(jax_app, ["check-data", str(root / "config.json"), "-o",
                                       str(out_j), *flags], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    check_datapoint.__dict__.pop("_warned_squim", None)  # the note comes once a process
    code, out = _port_cli(["check-data", str(root / "config.json"), "-o", str(out_p), *flags])
    assert code == 0, out
    assert "using native STOI/SI-SDR estimates" in out
    return (json.loads((out_j / "checked-data.json").read_text()),
            json.loads((out_p / "checked-data.json").read_text()), request.param)


def test_checked_data_rows_equal_jax(checked):
    want, got, mode = checked
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key, value in w.items():
            if isinstance(value, float):
                assert g[key] == pytest.approx(value, rel=ROW_ATOL, abs=ROW_ATOL), key
            else:
                assert g[key] == value, key
    clipped = {row["basename"]: row["total_clipped_samples"] for row in got}
    assert clipped["u1"] > (100 if mode == "thorough" else 10)
    assert all(np.isfinite(row["stoi"]) and np.isfinite(row["si_sdr"]) for row in got)


def test_coverage_scores_equal(workspace):
    root = workspace[0]
    items = load_filelist(root / "pre" / "training_filelist.psv") + load_filelist(
        root / "pre" / "validation_filelist.psv")
    # rows without token columns go through process_text
    items.append({"basename": "x", "characters": "a cab", "language": "default"})
    jitems = [dict(it) for it in items]
    add_coverage_scores(items, Preprocessor(FastSpeech2Config.from_file(root / "config.json")))
    j_add_coverage(jitems, JPreprocessor(JConfig.load_config_from_path(root / "config.json")))
    assert items == jitems
    assert len({it["trigram_coverage_score"] for it in items}) > 1


@pytest.fixture(scope="module")
def scores(workspace):
    root, orbax_dir, ckpt = workspace
    res = CliRunner().invoke(jax_app, ["check-data", str(root / "config.json"),
                                       "--no-calculate-stats", "--model-path", str(orbax_dir),
                                       "-o", str(root / "jax-scores")],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    code, out = _port_cli(["check-data", str(root / "config.json"), "--no-calculate-stats",
                           "--model-path", str(ckpt), "-o", str(root / "port-scores"),
                           "--device", "cpu"])
    assert code == 0, out
    assert "scores-0.psv" in out
    return (load_filelist(root / "jax-scores" / "scores-0.psv"),
            load_filelist(root / "port-scores" / "scores-0.psv"))


def test_scores_psv_equals_jax(scores):
    want, got = scores
    assert len(got) == len(want) == 3
    assert [r["basename"] for r in got] == [r["basename"] for r in want]
    assert list(got[0]) == list(want[0])
    losses = [k for k in want[0] if k.endswith("_loss")]
    assert {"total_loss", "spec_loss", "duration_loss", "attn_ctc_loss",
            "attn_bin_loss"} <= set(losses)
    assert "pitch_loss" not in losses  # no pitch or energy targets at inference
    for g, w in zip(got, want):
        for key in losses:
            assert float(g[key]) == pytest.approx(float(w[key]), rel=LOSS_RTOL, abs=1e-6), key
            assert np.isfinite(float(g[key]))
        for key in ("phone_coverage_score", "trigram_coverage_score"):
            assert float(g[key]) == pytest.approx(float(w[key]), rel=1e-6)
    totals = [float(r["total_loss"]) for r in got]
    assert totals == sorted(totals, reverse=True)


def test_scorer_writer_sorts_by_loss_then_coverage(tmp_path):
    from fastspeech2_lightning_tpu.synthesis.writers import ScorerWriter as JScorerWriter
    from fastspeech2_lightning_tpu_torch.synthesis.writers import ScorerWriter

    cfg = FastSpeech2Config()
    writers = (ScorerWriter(cfg, 7, tmp_path / "p", "output"),
               JScorerWriter(JConfig(), 7, tmp_path / "j", "output"))
    for i, (total, cov) in enumerate([(1.0, 0.5), (2.0, 0.1), (1.0, 0.2), (0.5, 0.9)]):
        batch = {"basename": [f"b{i}"], "speaker": ["s"], "language": ["l"],
                 "trigram_coverage_score": np.array([cov], np.float32)}
        outputs = {"losses": {"total": np.float32(total), "spec": np.float32(total / 2)}}
        for w in writers:
            w.on_predict_batch_end(outputs, batch)
    paths = [w.finalize() for w in writers]
    assert paths[0].name == "scores-7.psv"
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert [r["basename"] for r in load_filelist(paths[0])] == ["b1", "b2", "b0", "b3"]


def test_check_data_on_an_empty_filelist_exits_1(workspace, tmp_path):
    root = workspace[0]
    (tmp_path / "empty.psv").write_text("")
    code, out = _port_cli(["check-data", str(root / "config.json"), "-f",
                           str(tmp_path / "empty.psv"), "-o", str(tmp_path / "o")])
    res = CliRunner().invoke(jax_app, ["check-data", str(root / "config.json"), "-f",
                                       str(tmp_path / "empty.psv"), "-o", str(tmp_path / "j")])
    assert code == res.exit_code == 1
    assert "nothing to check" in out and "nothing to check" in res.output
