"""The PyTorch port's data loading and trainer, on the CPU, on a workspace the
JAX package preprocessed (``helpers.make_training_workspace``) with its
config dumped to JSON.

The port's BucketedLoader yields the same batches as the JAX package's for
the same seed: the same buckets, order, padding, fill rows and sample
weights, array for array. The port's ``train`` CLI with ``--device cpu``
runs two steps with finite losses, logs them and a validation, and writes
``checkpoints/step=2/``, which the port's Synthesizer loads and synthesizes
from. Resume is lossless: a checkpoint restores parameters, running
statistics, AdamW moments and count, EMA and epoch exactly, and the step
after a resume equals the uninterrupted one bit for bit; a fresh run starts
from ``finetune_checkpoint`` (a ``step=N/`` with its optimizer, a ``.ckpt``
with a fresh one at its global step). The checkpoint
directories a run leaves are those the JAX trainer's cadence rules
(``loop.py:687-719``, written out here) predict; early stopping, a float
``val_check_interval`` and SIGTERM behave as in the JAX trainer. Relative
paths in a JSON config resolve against its folder, and a YAML path is
refused."""

import json
import math
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.dataset import BucketedLoader as JBucketedLoader
from fastspeech2_lightning_tpu.dataset import load_datasets as j_load_datasets
from fastspeech2_lightning_tpu.text import lookuptables_from_config as j_lookups
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, load_datasets
from fastspeech2_lightning_tpu_torch.text.lookups import lookuptables_from_config
from fastspeech2_lightning_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_train_state,
    read_meta,
)
from fastspeech2_lightning_tpu_torch.training.loop import MONITOR, Trainer
from fastspeech2_lightning_tpu_torch.training.step import batch_to_device, train_step

from helpers import make_training_workspace

torch.set_num_threads(2)
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


def _config_file(workspace, version: str, **training) -> Path:
    """The workspace's config with its own log directory and `training`
    overrides, written beside the original."""
    root, _, path = workspace
    data = json.loads(path.read_text())
    data["training"]["logger"]["version"] = version
    data["training"].update(training)
    out = root / f"config_{version}.json"
    out.write_text(json.dumps(data))
    return out


def _trainer(workspace, version: str, **training) -> Trainer:
    return Trainer(FastSpeech2Config.from_file(_config_file(workspace, version, **training)),
                   device="cpu")


def _rows(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _cli(config: Path, *args):
    return [sys.executable, "-m", "fastspeech2_lightning_tpu_torch", "train", str(config),
            "--device", "cpu", *args]


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
    path = _config_file(workspace, "cli")
    out = subprocess.run(_cli(path, "--max-steps", "2"), cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    cfg = FastSpeech2Config.from_file(path)
    log_dir = Path(cfg.training.logger.save_dir) / cfg.training.logger.name / "cli"
    rows = _rows(log_dir / "train_log.jsonl")
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert {"total", "spec", "duration", "pitch", "energy", "attn_ctc", "attn_bin",
                "grad_norm", "ms", "epoch", "shape"} <= set(r)
        assert all(math.isfinite(v) for k, v in r.items() if k not in ("shape",))
    val = _rows(log_dir / "val_log.jsonl")
    assert [v["step"] for v in val] == [2] and val[0]["batches"] >= 1
    assert math.isfinite(val[0]["total"])
    step_dir = log_dir / "checkpoints" / "step=2"
    assert sorted(p.name for p in (log_dir / "checkpoints").iterdir()) == ["step=2"]
    assert sorted(p.name for p in step_dir.iterdir()) == ["meta.json", "model.ckpt",
                                                          "train_state.pt"]
    meta = read_meta(step_dir)
    assert meta["global_step"] == 2 and meta["optimizer_format"] == "per_leaf"
    assert load_train_state(step_dir)["count"] == 2

    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

    for ckpt in (step_dir, step_dir / "model.ckpt"):
        syn = Synthesizer.from_checkpoint(ckpt, device="cpu")
        assert syn.global_step == 2
        mel = syn.synthesize(["abcd dcba"]).mels[0]
        assert mel.ndim == 2 and mel.shape[1] == cfg.preprocessing.audio.n_mels
        assert np.isfinite(mel).all()
    with pytest.raises(ValueError, match="EMA"):
        Synthesizer.from_checkpoint(step_dir, device="cpu", use_ema=True)


def _state(trainer: Trainer) -> dict:
    opt = trainer.optimizer
    out = {f"model/{k}": v.clone() for k, v in trainer.model.state_dict().items()}
    for name, m, n, e in zip(opt.names, opt.mu, opt.nu, trainer.ema):
        out[f"mu/{name}"], out[f"nu/{name}"], out[f"ema/{name}"] = m.clone(), n.clone(), e.clone()
    return out


def _assert_equal_states(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_is_lossless_and_the_next_step_is_bit_equal(workspace):
    run = _trainer(workspace, "lossless", ema_decay=0.9, val_check_interval=2)
    run.fit(max_steps=3)
    saved = latest_checkpoint(run.ckpt_dir)
    assert saved.name == "step=3" and run.ckpt_path == saved
    back = _trainer(workspace, "lossless_back", ema_decay=0.9)
    step, epoch = back.restore(saved)
    assert (step, epoch) == (3, run._epoch) and epoch >= 1
    assert back.optimizer.count == run.optimizer.count == 3
    _assert_equal_states(_state(run), _state(back))

    batch = batch_to_device(next(iter(run.val_loader)), "cpu")
    for t in (run, back):
        losses = train_step(t.model, t.optimizer, t.config, batch, step, epoch, t.ema)
        t.last = {k: float(v) for k, v in losses.items()}
    assert run.last == back.last
    _assert_equal_states(_state(run), _state(back))


@pytest.mark.parametrize("source", ["step_dir", "ckpt"])
def test_a_fresh_run_starts_from_finetune_checkpoint(workspace, source):
    base = _trainer(workspace, f"finetune_base_{source}", ema_decay=0.9)
    base.fit(max_steps=3)
    start = base.ckpt_path if source == "step_dir" else base.ckpt_path / "model.ckpt"
    tuned = _trainer(workspace, f"finetune_{source}", ema_decay=0.9,
                     finetune_checkpoint=str(start))
    rows = tuned.fit(max_steps=5)
    assert [r["step"] for r in rows] == [4, 5]
    if source == "step_dir":  # the whole state: AdamW goes on counting
        assert tuned.optimizer.count == 5
    else:  # weights only: a fresh optimizer from the checkpoint's global step
        assert tuned.optimizer.count == 2
    back = _trainer(workspace, f"finetune_check_{source}", ema_decay=0.9)
    assert back.restore(start)[0] == 3
    for name, value in back.model.state_dict().items():
        assert torch.equal(value, base.model.state_dict()[name]), name


def _jax_cadence(epoch_len, max_steps, val_every, ckpt_steps, ckpt_epochs, top_k, val_totals):
    """The checkpoints the JAX trainer leaves (loop.py:687-719 and
    prune_checkpoints): {step: metric or None}."""
    def crossed(interval, lo, hi):
        return bool(interval) and hi // interval > lo // interval

    saved: dict = {}

    def save(step, metric=None):
        saved[step] = metric  # a later save at the same step replaces the earlier
        if len(saved) > top_k:
            latest = max(saved)
            scored = sorted((m, s) for s, m in saved.items() if m is not None)[:top_k]
            keep = {s for _, s in scored} | {latest}
            for s in list(saved):
                if s not in keep:
                    del saved[s]

    step = epoch = 0
    while step < max_steps:
        for _ in range(epoch_len):
            prev, step = step, step + 1
            if ckpt_steps and crossed(ckpt_steps, prev, step):
                save(step)
            if crossed(val_every, prev, step) or step >= max_steps:
                save(step, val_totals[step])
            if step >= max_steps:
                break
        epoch += 1
        if ckpt_epochs and epoch % ckpt_epochs == 0:
            save(step)
    save(step)
    return saved


@pytest.mark.parametrize("top_k", [2, 100])
def test_checkpoint_dirs_follow_the_jax_cadence(workspace, top_k):
    trainer = _trainer(workspace, f"cadence{top_k}", val_check_interval=3, ckpt_steps=2,
                       ckpt_epochs=2, save_top_k_ckpts=top_k)
    trainer.fit(max_steps=8)
    val = {r["step"]: r["total"] for r in _rows(trainer.log_dir / "val_log.jsonl")}
    assert sorted(val) == [3, 6, 8]
    epoch_len = len(trainer.loader)
    assert 1 < epoch_len < 8
    want = _jax_cadence(epoch_len, 8, 3, 2, 2, top_k, val)
    dirs = sorted(trainer.ckpt_dir.iterdir())
    got = {int(p.name.split("=")[1]): read_meta(p)["metrics"].get(MONITOR) for p in dirs}
    assert got == want
    assert trainer.ckpt_path.name == "step=8"


def test_early_stopping_after_patience_stale_validations(workspace):
    trainer = _trainer(workspace, "early", val_check_interval=1,
                       early_stopping={"metric": "mae", "patience": 2})
    totals = iter([3.0, 2.0, 2.0 - 5e-7, 2.5, 1.0])
    trainer.validate = lambda step, epoch: {"total": next(totals)}
    rows = trainer.fit(max_steps=20)
    # 3.0 best, 2.0 best, 2.0 - 5e-7 not better by 1e-6 (stale 1), 2.5 (stale 2): stop
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert trainer.ckpt_path.name == "step=4"


def test_float_val_check_interval_is_a_fraction_of_an_epoch(workspace):
    trainer = _trainer(workspace, "fraction", val_check_interval=1.0)
    trainer.fit(max_steps=7)
    epoch_len = len(trainer.loader)
    assert 1 < epoch_len and 2 * epoch_len < 7
    val = [r["step"] for r in _rows(trainer.log_dir / "val_log.jsonl")]
    assert val == [k * epoch_len for k in range(1, 7 // epoch_len + 1)] + [7]


def test_sigterm_checkpoints_the_logged_step_and_a_rerun_resumes(workspace):
    path = _config_file(workspace, "preempt")
    log_dir = Path(FastSpeech2Config.from_file(path).training.logger.save_dir) / \
        "BaseExperiment" / "preempt"
    proc = subprocess.Popen(_cli(path, "--max-steps", "100000"), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        log = log_dir / "train_log.jsonl"
        while time.time() < deadline and proc.poll() is None:
            if log.exists() and len(log.read_text().splitlines()) >= 3:
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    assert "received signal" in out
    steps = [r["step"] for r in _rows(log)]
    s = steps[-1]
    assert steps == list(range(1, s + 1)) and s >= 3
    ckpt = latest_checkpoint(log_dir / "checkpoints")
    assert ckpt.name == f"step={s}" and load_train_state(ckpt)["count"] == s

    again = subprocess.run(_cli(path, "--max-steps", str(s + 2)), cwd=REPO,
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert f"resumed from {ckpt} at step {s}" in again.stdout
    assert [r["step"] for r in _rows(log)] == list(range(1, s + 3))
    assert latest_checkpoint(log_dir / "checkpoints").name == f"step={s + 2}"


def test_config_paths_resolve_against_the_file_and_yaml_is_refused(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "training.json").write_text(json.dumps({"batch_size": 3}))
    path = tmp_path / "sub" / "config.json"
    path.write_text(json.dumps({
        "preprocessing": {"save_dir": "pre"},
        "path_to_training_config_file": "training.json",
        "training": {"seed": 5, "training_filelist": "pre/train.psv",
                     "val_check_interval": 0.25,
                     "early_stopping": {"metric": "mae", "patience": 7}},
    }))
    cfg = FastSpeech2Config.from_file(path)
    assert cfg.preprocessing.save_dir == str((tmp_path / "sub" / "pre").resolve())
    assert cfg.training.training_filelist == str((tmp_path / "sub" / "pre" / "train.psv").resolve())
    assert (cfg.training.batch_size, cfg.training.seed) == (3, 5)
    assert cfg.training.val_check_interval == 0.25
    assert (cfg.training.early_stopping.metric, cfg.training.early_stopping.patience) == ("mae", 7)
    assert (cfg.training.save_top_k_ckpts, cfg.training.ckpt_epochs,
            cfg.training.prefetch_batches) == (5, 1, 2)
    with pytest.raises(ValueError, match="JSON"):
        FastSpeech2Config.from_file(tmp_path / "config.yaml")
