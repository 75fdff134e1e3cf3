"""The PyTorch port's data loading and trainer, on the CPU, on a workspace the
JAX package preprocessed (``helpers.make_training_workspace``) with its
config dumped to JSON.

The port's BucketedLoader yields the same batches as the JAX package's for
the same seed: the same buckets, order, padding, fill rows and sample
weights, array for array. The port's ``train`` CLI with ``--device cpu``
runs two steps with finite losses, logs them, and writes ``last.ckpt``,
which the port's Synthesizer loads and synthesizes from. Relative paths in a
JSON config resolve against its folder, and a YAML path is refused."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fastspeech2_lightning_tpu.dataset import BucketedLoader as JBucketedLoader
from fastspeech2_lightning_tpu.dataset import load_datasets as j_load_datasets
from fastspeech2_lightning_tpu.text import lookuptables_from_config as j_lookups
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, load_datasets
from fastspeech2_lightning_tpu_torch.text.lookups import lookuptables_from_config

from helpers import make_training_workspace

REPO = Path(__file__).resolve().parents[1]
KEYS = ("text", "src_lens", "mel", "mel_lens", "pitch", "energy", "attn_prior",
        "speaker_id", "language_id", "sample_weight")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    jcfg = make_training_workspace(root, n_utts=7, batch_size=2, bucket_count=2)
    path = root / "config.json"
    path.write_text(json.dumps(jcfg.model_checkpoint_dump()))
    return root, jcfg, path


def test_bucketed_loader_yields_the_jax_batches(workspace):
    _, jcfg, path = workspace
    cfg = FastSpeech2Config.from_file(path)
    j_train, _ = j_load_datasets(jcfg, *j_lookups(jcfg))
    train, _ = load_datasets(cfg, *lookuptables_from_config(cfg))
    kwargs = dict(n_buckets=2, seed=3, max_mel_length=cfg.model.max_mel_length)
    jl = JBucketedLoader(j_train, 2, **kwargs)
    tl = BucketedLoader(train, 2, **kwargs)
    assert [(b.max_text, b.max_mel, list(b.indices)) for b in tl.buckets] == [
        (b.max_text, b.max_mel, [int(i) for i in b.indices]) for b in jl.buckets]
    n = 0
    for _ in range(2):  # two epochs: the generator's state carries over
        for jb, tb in zip(jl, tl, strict=True):
            for key in KEYS:
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
            n += 1
    assert n == 2 * len(tl)
    assert any(b["sample_weight"].min() == 0 for b in tl)  # a filled partial batch


def test_train_cli_on_cpu_writes_a_checkpoint_that_synthesizes(workspace):
    root, _, path = workspace
    out = subprocess.run(
        [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "train", str(path),
         "--max-steps", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    cfg = FastSpeech2Config.from_file(path)
    log_dir = Path(cfg.training.logger.save_dir) / cfg.training.logger.name / cfg.training.logger.version
    rows = [json.loads(line) for line in (log_dir / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert {"total", "spec", "duration", "pitch", "energy", "attn_ctc", "attn_bin",
                "grad_norm", "ms", "epoch", "shape"} <= set(r)
        assert all(math.isfinite(v) for k, v in r.items() if k not in ("shape",))

    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

    syn = Synthesizer.from_checkpoint(log_dir / "checkpoints" / "last.ckpt", device="cpu")
    result = syn.synthesize(["abcd dcba"])
    mel = result.mels[0]
    assert mel.ndim == 2 and mel.shape[1] == cfg.preprocessing.audio.n_mels
    assert np.isfinite(mel).all()


def test_config_paths_resolve_against_the_file_and_yaml_is_refused(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "training.json").write_text(json.dumps({"batch_size": 3}))
    path = tmp_path / "sub" / "config.json"
    path.write_text(json.dumps({
        "preprocessing": {"save_dir": "pre"},
        "path_to_training_config_file": "training.json",
        "training": {"seed": 5, "training_filelist": "pre/train.psv"},
    }))
    cfg = FastSpeech2Config.from_file(path)
    assert cfg.preprocessing.save_dir == str((tmp_path / "sub" / "pre").resolve())
    assert cfg.training.training_filelist == str((tmp_path / "sub" / "pre" / "train.psv").resolve())
    assert (cfg.training.batch_size, cfg.training.seed) == (3, 5)
    with pytest.raises(ValueError, match="JSON"):
        FastSpeech2Config.from_file(tmp_path / "config.yaml")
