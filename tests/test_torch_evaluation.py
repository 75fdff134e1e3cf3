"""The PyTorch port's vocoder evaluation (evaluation.py,
preprocessing/objective.py) and its ``train-vocoder`` / ``evaluate-vocoder``
commands, against the JAX package.

The objective metrics (SI-SDR, STOI, the PESQ-shaped proxy) equal the JAX
module's within 1e-6 on seeded signals, short and degenerate ones included.
``evaluate_vocoder`` gives JAX's report on the same workspace and
``vocoder.npz`` within 1e-4 relative (1e-6 absolute for a metric near 0:
the STOI of a random vocoder's noise is about 0), the utterances vocoded
by each package within 1e-5 of the other. Through the port's CLI with
``--device cpu``, ``train-vocoder`` trains the default HiFiGAN V1 against
the default discriminators two steps and ``evaluate-vocoder`` scores the
``vocoder.npz`` it wrote as JAX's ``evaluate_vocoder`` does."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu import evaluation as j_eval
from fastspeech2_lightning_tpu.models import hifigan as jh
from fastspeech2_lightning_tpu.preprocessing import objective as j_obj
from fastspeech2_lightning_tpu_torch import cli, evaluation
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.preprocessing import objective as p_obj

from helpers import make_training_workspace

torch.set_num_threads(2)
METRICS = ("mel_l1", "si_sdr_db", "stoi", "pesq_proxy")


def _signals(sr: int, seconds: float, snr_db, shift: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 140.0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))
    clean = sum(np.sin(2 * np.pi * np.cumsum(f0 * h) / sr) / h for h in range(1, 6))
    clean = (0.3 * clean * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))).astype(np.float32)
    if snr_db is None:
        return clean, clean.copy()
    noise = rng.standard_normal(clean.size)
    noise *= np.linalg.norm(clean) / np.linalg.norm(noise) / 10 ** (snr_db / 20)
    return clean, np.roll(clean + noise, shift).astype(np.float32)


@pytest.mark.parametrize("sr,seconds,snr_db,shift", [
    (22050, 1.5, 0.0, 0), (22050, 1.5, 10.0, 37), (16000, 2.0, 25.0, 0),
    (22050, 1.0, None, 0),  # a perfect reconstruction: SI-SDR's 100 dB cap
    (22050, 0.2, 5.0, 0),  # shorter than STOI's 30 frames: NaN
])
def test_objective_metrics_match_jax(sr, seconds, snr_db, shift):
    clean, degraded = _signals(sr, seconds, snr_db, shift, seed=int(sr * seconds))
    for name, args in (("si_sdr", (degraded, clean)), ("stoi", (clean, degraded, sr)),
                       ("pesq_proxy", (clean, degraded, sr))):
        got, want = getattr(p_obj, name)(*args), getattr(j_obj, name)(*args)
        assert isinstance(got, float)
        if np.isnan(want):
            assert np.isnan(got), name
        else:
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, got, want)


def test_si_sdr_of_a_silent_reference_matches_jax():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert p_obj.si_sdr(x, np.zeros(1000)) == j_obj.si_sdr(x, np.zeros(1000)) == float("-inf")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ews")
    jcfg = make_training_workspace(root, n_utts=6)
    path = root / "config.json"
    path.write_text(json.dumps(jcfg.model_checkpoint_dump()))
    return root, jcfg, path


def _npz(root, scale: float):
    """A small random HiFiGAN written as the JAX package writes vocoder.npz;
    weights of std 0.02 * scale."""
    cfg = jh.HiFiGANConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3),), n_mels=20)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(scale),
                                    jh.init_random_hifigan(cfg, seed=4))
    path = root / f"voc_{scale}.npz"
    np.savez(path, params=np.array(params, dtype=object),
             config=np.array(vars(cfg), dtype=object), global_step=7)
    return path


def _close(got: dict, want: dict) -> None:
    assert got["n"] == want["n"]
    for k in METRICS:
        assert abs(got[k] - want[k]) <= max(1e-4 * abs(want[k]), 1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("scale", [1.0, 5.0], ids=["init", "louder"])
def test_evaluate_vocoder_matches_jax(workspace, scale):
    root, jcfg, path = workspace
    voc = _npz(root, scale)
    want = j_eval.evaluate_vocoder(jcfg, voc, n_utterances=16)
    got = evaluation.evaluate_vocoder(FastSpeech2Config.from_file(path), voc, n_utterances=16,
                                      device="cpu")
    assert got["n"] >= 1 and set(got) == set(want)
    _close(got, want)


def test_evaluate_vocoder_counts_and_skips_like_jax(workspace, tmp_path):
    """n caps the utterances; rows without artifacts are skipped; none left raises."""
    root, jcfg, path = workspace
    voc = _npz(root, 5.0)
    pcfg = FastSpeech2Config.from_file(path)
    rows = (root / "pre" / "training_filelist.psv").read_text().splitlines()
    flist = tmp_path / "list.psv"
    flist.write_text("\n".join([rows[0], "missing|default|default|ab cd"] + rows[1:4]) + "\n")
    want = j_eval.evaluate_vocoder(jcfg, voc, n_utterances=2, filelist=flist)
    got = evaluation.evaluate_vocoder(pcfg, voc, n_utterances=2, filelist=flist, device="cpu")
    assert got["n"] == want["n"] == 2
    _close(got, want)
    empty = tmp_path / "empty.psv"
    empty.write_text(rows[0] + "\nmissing|default|default|ab cd\n")
    with pytest.raises(FileNotFoundError, match="no validation utterances"):
        evaluation.evaluate_vocoder(pcfg, voc, filelist=empty, device="cpu")


def test_train_vocoder_then_evaluate_through_the_cli(workspace):
    root, jcfg, path = workspace
    cli.main(["train-vocoder", str(path), "--max-steps", "2", "--batch-size", "2",
              "--frames-per-crop", "8", "--log-steps", "1", "--device", "cpu"])
    log_dir = root / "logs" / "vocoder"
    rows = [json.loads(line) for line in (log_dir / "vocoder_log.jsonl").open()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in ("d", "g", "g_adv", "fm", "mel_l1"))
    voc = log_dir / "checkpoints" / "vocoder.npz"
    assert (log_dir / "checkpoints" / "step=2" / "meta.json").exists()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["evaluate-vocoder", str(path), "-v", str(voc), "-n", "3", "--device", "cpu"])
    got = json.loads(out.getvalue())
    want = j_eval.evaluate_vocoder(jcfg, voc, n_utterances=3)
    _close(got, want)
