"""``training.steps_per_call`` in the port against the JAX package, on the CPU.

- ``loop.group_steps`` gives the JAX trainer's ``_group_steps`` sequence on
  the same NumPy-seeded batches (runs of k of one signature stacked, a
  change of shape flushing the pending run, stragglers alone), and on the
  port loader's batches of a corpus;
- ``Trainer.fit(max_steps=5)`` with ``val_check_interval=3`` at
  ``steps_per_call`` 2 (the CPU runs each call as eager steps with one fetch
  of the losses) and at 1: both end at step 5, log the same rows, validate
  and checkpoint where the JAX trainer's call windows say (``loop.py:620-690``,
  written out here over JAX's own grouping of the same batches: a tail
  group split so the run stops at max_steps), and end on the same weights
  within ``tests/test_training.py``'s multi-step tolerance;
- ``steps_per_call`` 0 is refused, as JAX's ``ge=1`` refuses it;
- under a layout of more than one process the trainer prints JAX's
  "steps_per_call > 1 requires an unsharded run; using 1" and runs k = 1.
"""

import json

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.config import FastSpeech2Config as JConfig
from fastspeech2_lightning_tpu.training.loop import _group_steps as j_group_steps
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, load_datasets
from fastspeech2_lightning_tpu_torch.parallel import mesh
from fastspeech2_lightning_tpu_torch.parallel.mesh import ParallelLayout
from fastspeech2_lightning_tpu_torch.text.lookups import lookuptables_from_config
from fastspeech2_lightning_tpu_torch.training import loop
from fastspeech2_lightning_tpu_torch.training.checkpoint import read_meta
from fastspeech2_lightning_tpu_torch.training.loop import MONITOR, Trainer, group_steps

from helpers import make_training_workspace

torch.set_num_threads(2)
MAX_STEPS, VAL_EVERY = 5, 3
RTOL, ATOL = 1e-4, 1e-5  # tests/test_training.py:463's final-parameter tolerance


def _batch(rng, B, L, T):
    return {"text": rng.integers(1, 30, (B, L)).astype(np.int32),
            "src_lens": np.full(B, L, np.int32),
            "mel": rng.standard_normal((B, T, 4)).astype(np.float32),
            "mel_lens": np.full(B, T, np.int32),
            "sample_weight": np.ones(B, np.float32),
            "basename": [f"u{i}" for i in range(B)], "n_real_global": B}


def _summary(groups):
    """(n, text shape, mel shape, text bytes) of each yielded group."""
    return [(n, b["text"].shape, b["mel"].shape, b["text"].tobytes()) for n, b in groups]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_grouping_matches_jax_group_steps(k):
    rng = np.random.default_rng(k)
    shapes = [(2, 8, 16), (2, 8, 24)]
    # runs of one shape of every length 1..5, and a shape change each time
    batches = [_batch(rng, *shapes[run % 2]) for run, n in enumerate([3, 1, 5, 2, 4, 1, 1, 3])
               for _ in range(n)]
    got, want = list(group_steps(batches, k)), list(j_group_steps(batches, k))
    assert _summary(got) == _summary(want)
    assert any(n == k for n, _ in got) and any(n == 1 for n, _ in got)
    for (n, b), (_, jb) in zip(got, want):
        for key in ("src_lens", "mel", "mel_lens", "sample_weight"):
            np.testing.assert_array_equal(b[key], jb[key])
        if n == 1:
            assert b is jb


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    jcfg = make_training_workspace(root, n_utts=7, batch_size=2, bucket_count=2)
    path = root / "config.json"
    path.write_text(json.dumps(jcfg.model_checkpoint_dump()))
    return root, path


def _config(workspace, version: str, **training) -> FastSpeech2Config:
    _, path = workspace
    data = json.loads(path.read_text())
    data["training"]["logger"]["version"] = version
    data["training"].update(training)
    return FastSpeech2Config.from_dict(data)


def _epochs(config, n: int) -> list:
    """The training loader's batches of `n` epochs, as the trainer draws them."""
    train_ds, _ = load_datasets(config, *lookuptables_from_config(config))
    tcfg = config.training
    loader = BucketedLoader(train_ds, tcfg.batch_size, n_buckets=tcfg.bucket_count,
                            seed=tcfg.seed, max_mel_length=config.model.max_mel_length)
    return [list(loader) for _ in range(n)]


def test_grouping_of_the_corpus_batches_matches_jax(workspace):
    config = _config(workspace, "groups")
    for batches in _epochs(config, 2):
        assert _summary(group_steps(batches, 2)) == _summary(j_group_steps(batches, 2))


def _jax_windows(config, k: int, max_steps: int) -> list:
    """The (prev, step] windows of the JAX trainer's calls (``loop.py:
    620-690``): JAX's grouping of each epoch's batches, a tail group split
    into single steps so the run stops at max_steps."""
    windows, step = [], 0
    for batches in _epochs(config, max_steps):
        for n, _ in j_group_steps(batches, k):
            sizes = [1] * (max_steps - step) if n > 1 and step + n > max_steps else [n]
            for n_i in sizes:
                windows.append((step, step + n_i))
                step += n_i
            if step >= max_steps:
                return windows
    return windows


def _crossed(interval, lo, hi):
    return bool(interval) and hi // interval > lo // interval


def test_fit_at_two_steps_a_call_matches_one(workspace):
    runs = {}
    for k in (1, 2):
        trainer = Trainer(_config(workspace, f"k{k}", steps_per_call=k,
                                  val_check_interval=VAL_EVERY, save_top_k_ckpts=100,
                                  ckpt_epochs=0), device="cpu")
        rows = trainer.fit(max_steps=MAX_STEPS)
        val = [r["step"] for r in map(json.loads, (trainer.log_dir / "val_log.jsonl")
                                      .read_text().splitlines())]
        ckpts = {int(p.name.split("=")[1]): read_meta(p)["metrics"].get(MONITOR)
                 for p in trainer.ckpt_dir.iterdir()}
        logged = [json.loads(line) for line in
                  (trainer.log_dir / "train_log.jsonl").read_text().splitlines()]
        runs[k] = dict(rows=rows, logged=logged, val=val, ckpts=ckpts,
                       weights={n: p.detach().clone()
                                for n, p in trainer.model.state_dict().items()},
                       count=trainer.optimizer.count, config=trainer.config)
    one, two = runs[1], runs[2]
    for run in (one, two):
        assert [r["step"] for r in run["rows"]] == list(range(1, MAX_STEPS + 1))
        assert run["logged"] == run["rows"] and run["count"] == MAX_STEPS

    def losses(rows):
        return [{key: v for key, v in r.items() if key not in ("ms", "wait_ms", "call_steps")}
                for r in rows]

    assert losses(two["rows"]) == losses(one["rows"])
    windows = _jax_windows(two["config"], 2, MAX_STEPS)
    assert [r["call_steps"] for r in two["rows"]] == [
        hi - lo for lo, hi in windows for _ in range(hi - lo)]
    assert any(hi - lo == 2 for lo, hi in windows)
    want_val = [hi for lo, hi in windows if _crossed(VAL_EVERY, lo, hi) or hi >= MAX_STEPS]
    assert two["val"] == want_val and one["val"] == [3, 5]
    assert set(two["ckpts"]) == set(want_val) and set(one["ckpts"]) == {3, 5}
    # a validation's checkpoint holds its metric; the final save replaces step 5's
    assert all(two["ckpts"][s] is not None for s in want_val if s < MAX_STEPS)
    for name, w in one["weights"].items():
        torch.testing.assert_close(two["weights"][name], w, rtol=RTOL, atol=ATOL, msg=name)


def test_steps_per_call_below_1_is_refused(workspace):
    _, path = workspace
    data = json.loads(path.read_text())
    data["training"]["steps_per_call"] = 0
    with pytest.raises(ValueError, match="steps_per_call must be >= 1"):
        FastSpeech2Config.from_dict(data)
    bad = path.parent / "config_k0.json"
    bad.write_text(json.dumps(data))
    with pytest.raises(Exception, match="greater than or equal to 1"):
        JConfig.load_config_from_path(bad)
    assert FastSpeech2Config.from_dict({"training": {"steps_per_call": 3}}).training \
        .steps_per_call == 3


@pytest.mark.parametrize("data,model,want", [(2, 1, 1), (1, 2, 1), (1, 1, 4)])
def test_a_layout_of_several_processes_runs_one_step_a_call(capsys, data, model, want):
    lay = ParallelLayout(world_size=data * model, data_size=data, model_size=model)
    assert loop.steps_per_call(4, lay, is_main=True) == want
    printed = capsys.readouterr().out
    assert (loop.UNSHARDED_ONLY in printed) == (want == 1)
    assert loop.UNSHARDED_ONLY == "steps_per_call > 1 requires an unsharded run; using 1"
    assert loop.steps_per_call(4, lay, is_main=False) == want
    assert capsys.readouterr().out == ""


def test_a_distributed_fit_prints_the_notice_and_steps_singly(workspace, monkeypatch, capsys):
    """The trainer itself under an installed layout of data=2 (the rank's
    collectives stubbed: this checks the notice and the calls, not the
    sums): one row per step, each a call of one."""
    lay = ParallelLayout(world_size=2, data_size=2)
    monkeypatch.setattr(mesh, "_current", None)  # the installed layout goes after the test
    monkeypatch.setattr(loop, "make_layout", lambda mp: lay)
    monkeypatch.setattr(loop, "barrier", lambda: None)
    monkeypatch.setattr(Trainer, "_preempted", lambda self, flag: flag)
    trainer = Trainer(_config(workspace, "dist", steps_per_call=2, batch_size=2,
                              val_check_interval=100), device="cpu")
    monkeypatch.setattr(trainer, "_save", lambda *a, **k: None)
    monkeypatch.setattr(trainer, "validate", lambda step, epoch: {"total": 1.0})
    calls = []
    monkeypatch.setattr(trainer, "_train_call", lambda n, db, step, epoch: (
        calls.append(n) or [{"total": 1.0}] * n))
    rows = trainer.fit(max_steps=3)
    assert trainer.layout is lay
    assert loop.UNSHARDED_ONLY in capsys.readouterr().out
    assert calls == [1, 1, 1] and [r["call_steps"] for r in rows] == [1, 1, 1]
