"""The port's trainer across processes on the CPU (gloo), as
``tests/test_multihost.py`` holds the JAX trainer: a workspace the JAX
package preprocessed (8 utterances, global B 8, ``val_check_interval`` 2,
4 steps, f32), fitted by one process and by 2 ranks, data=2 and model=2.

- ``step=4/`` holds the one-process Adam moments (rtol 1e-5, atol 1e-6); its
  update since the initial weights, and the EMA's, equal one process's
  tensor by tensor within rel-L2 1e-3, and the weights and EMA hold to rtol
  1e-5 / atol 1e-6, on the elements whose first moments agree to 1e-3
  relative (``parallel.launch.settled``: a gradient that is zero to rounding
  has a sign that summation order decides, which Adam turns into a step of
  the full rate; at most 1 % left out). Noam's rates over the 4 steps are
  3.3e-5 to 1e-4, 33 to 100 times atol. The buffers hold to rtol
  1e-5 / atol 1e-6, but for the running means of the BatchNorms that
  follow a conv bias: such a bias's gradient is zero to rounding, and its
  running mean moves with it, by up to twice the rates summed. The
  validations report the one-process metrics;
- only rank 0 wrote: one train_log row a step, one val_log row a
  validation, one event file;
- a 2-rank ``step=2/`` resumes in one process, and a one-process ``step=2/``
  in 2 ranks, and both reach the uninterrupted run's ``step=4/``;
- a rank's loader yields the JAX loader's shard of each global batch;
- a global batch of 6 over 4 data ranks raises the ValueError naming both;
- ``python -m fastspeech2_lightning_tpu_torch train CONFIG --distributed
  --device cpu`` in 2 processes, launched through the ``FS2T_*`` variables
  and through torchrun, reaches ``step=4/``.

Ranks are spawned by ``parallel.launch.run_local``; the worker functions
import no JAX."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.parallel.launch import (
    free_port,
    run_local,
    settled,
    update_errors,
)
from fastspeech2_lightning_tpu_torch.training.checkpoint import load_train_state
from fastspeech2_lightning_tpu_torch.training.loop import Trainer
from fastspeech2_lightning_tpu_torch.training.state import noam_lr

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
STEPS = 4
RTOL, ATOL = 1e-5, 1e-6
WARMUP = 30  # Noam rates 3.3e-5 .. 1e-4 over the 4 steps
UPDATE_RTOL = 1e-3  # rel-L2 of the update since the initial weights, tensor by tensor
LEFT_OUT = 1e-2  # the share of elements whose gradient is zero to rounding
# the BatchNorms whose input carries a conv's bias (conformer conv module,
# PostNet): their running means move with that bias
AFTER_BIAS = re.compile(r".*(conv_module\.sequential\.3|postnet\.convolutions\.\d\.1)"
                        r"\.running_mean$")
TIMEOUT_S = 150.0


def _config(path, version: str, **training) -> FastSpeech2Config:
    data = json.loads(Path(path).read_text())
    data["training"]["logger"]["version"] = version
    data["training"].update(training)
    return FastSpeech2Config.from_dict(data)


def _fit(path, version, model_parallel=1, steps=STEPS, **training):
    trainer = Trainer(_config(path, version, **training), device="cpu",
                      model_parallel=model_parallel)
    rows = trainer.fit(max_steps=steps)
    return [{k: v for k, v in r.items() if k not in ("ms", "wait_ms")} for r in rows]


def _fit_worker(rank, world, model_parallel, path, runs):
    """Each (version, steps) of `runs` in turn, one Trainer each."""
    return [_fit(path, version, model_parallel, steps) for version, steps in runs]


def _batch_size_worker(rank, world, path):
    try:
        Trainer(_config(path, "b6", batch_size=6), device="cpu")
    except ValueError as e:
        return str(e)
    return None


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from helpers import make_training_workspace

    root = tmp_path_factory.mktemp("dist")
    jcfg = make_training_workspace(root, n_utts=8, batch_size=8, val_check_interval=2,
                                   prefetch_batches=0, ema_decay=0.9,
                                   model_overrides={"dtype": "float32"})
    data = jcfg.model_checkpoint_dump()
    data["training"]["optimizer"]["warmup_steps"] = WARMUP
    data["training"]["ckpt_epochs"] = None  # step=2/ and step=4/ only

    path = root / "config.json"
    path.write_text(json.dumps(data))
    return root, path


def _run_dir(root, version) -> Path:
    return root / "logs" / "BaseExperiment" / version


def _ckpt(root, version, step) -> Path:
    return _run_dir(root, version) / "checkpoints" / f"step={step}"


def _copy_ckpt(root, src_version, step, dst_version) -> None:
    dst = _ckpt(root, dst_version, step)
    dst.parent.mkdir(parents=True)
    shutil.copytree(_ckpt(root, src_version, step), dst)


def _initial(path) -> dict:
    """A trainer's initial weights, which its EMA starts from too."""
    trainer = Trainer(_config(path, "init"), device="cpu")
    weights = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return {"weights": weights, "ema": weights}


@pytest.fixture(scope="module")
def runs(workspace):
    root, path = workspace
    out = {"init": _initial(path), "one": _fit(path, "one")}
    _copy_ckpt(root, "one", 2, "cross12")  # one process's step=2, resumed by 2 ranks
    out["data2"] = run_local(_fit_worker, 2, 1, path, [("data2", STEPS)],
                             timeout_s=TIMEOUT_S)[0][0]
    model2 = run_local(_fit_worker, 2, 2, path, [("model2", STEPS), ("cross12", STEPS)],
                       timeout_s=TIMEOUT_S)
    out["model2"], out["cross12"] = model2[0]
    _copy_ckpt(root, "data2", 2, "cross21")  # 2 ranks' step=2, resumed by one process
    out["cross21"] = _fit(path, "cross21")
    # a resumed fit draws its batches from a fresh loader (as in JAX): its
    # reference is one process resumed from one process's step=2
    _copy_ckpt(root, "one", 2, "resumed")
    out["resumed"] = _fit(path, "resumed")
    return out


def _state(ckpt: Path) -> dict:
    """The weights, buffers, EMA and Adam moments of a step=N/ directory."""
    out = load_train_state(ckpt)
    out["weights"] = torch.load(ckpt / "model.ckpt", map_location="cpu",
                                weights_only=False)["state_dict"]
    return out


def _assert_same_checkpoint(got: Path, want: Path, got_from, want_from) -> None:
    """`got` holds `want`'s moments; its update since `got_from` (a step=N/
    or the initial state), and its EMA's, are `want`'s since `want_from`."""
    a, b = _state(got), _state(want)
    a0, b0 = (x if isinstance(x, dict) else _state(x) for x in (got_from, want_from))
    assert a["weights"].keys() == b["weights"].keys() and a["count"] == b["count"]
    for part in ("mu", "nu"):
        for k in b[part]:
            np.testing.assert_allclose(a[part][k].numpy(), b[part][k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{part} {k}")
    keep = settled([(a["mu"], b["mu"])])
    for part in ("weights", "ema"):
        names = list(b["mu"])
        errors = update_errors({k: a[part][k].double() - a0[part][k].double() for k in names},
                               {k: b[part][k].double() - b0[part][k].double() for k in names},
                               keep)
        left = sum(e[1] for e in errors.values()) / sum(e[2] for e in errors.values())
        assert left <= LEFT_OUT, f"{part}: {left:.3g} of the elements left out"
        bad = {k: e for k, e in errors.items() if e[0] > UPDATE_RTOL}
        assert not bad, f"{part} update rel-L2 above {UPDATE_RTOL}: {bad}"
        for k in names:
            np.testing.assert_allclose(a[part][k].numpy()[keep[k]], b[part][k].numpy()[keep[k]],
                                       rtol=RTOL, atol=ATOL, err_msg=f"{part} {k}")
    rates = sum(noam_lr(1e-3, WARMUP, k) for k in range(b["count"]))
    for k in b["weights"]:  # the buffers: BatchNorm's running statistics, the bins
        if k not in b["mu"]:
            atol = ATOL + (2 * rates if AFTER_BIAS.match(k) else 0.0)
            np.testing.assert_allclose(a["weights"][k].float().numpy(),
                                       b["weights"][k].float().numpy(), rtol=RTOL, atol=atol,
                                       err_msg=k)


def _val_rows(root, version):
    lines = (_run_dir(root, version) / "val_log.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


@pytest.mark.parametrize("version", ["data2", "model2"])
def test_two_rank_fit_reaches_the_one_process_checkpoint(workspace, runs, version):
    root, _ = workspace
    _assert_same_checkpoint(_ckpt(root, version, STEPS), _ckpt(root, "one", STEPS),
                            runs["init"], runs["init"])
    for got, want in zip(runs[version], runs["one"]):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=RTOL, abs=ATOL), (k, got[k], v)


@pytest.mark.parametrize("version", ["data2", "model2"])
def test_two_rank_validation_reports_the_one_process_metrics(workspace, runs, version):
    root, _ = workspace
    got, want = _val_rows(root, version), _val_rows(root, "one")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        for k in w:
            if k not in ("ms", "batches"):
                assert g[k] == pytest.approx(w[k], rel=RTOL, abs=ATOL), (k, g[k], w[k])
    meta = json.loads((_ckpt(root, version, 2) / "meta.json").read_text())
    want_meta = json.loads((_ckpt(root, "one", 2) / "meta.json").read_text())
    assert meta["metrics"]["validation/total_loss"] == pytest.approx(
        want_meta["metrics"]["validation/total_loss"], rel=RTOL, abs=ATOL)
    assert meta["optimizer_format"] == "per_leaf"


@pytest.mark.parametrize("version", ["data2", "model2"])
def test_only_rank_0_writes(workspace, runs, version):
    root, _ = workspace
    run = _run_dir(root, version)
    assert len((run / "train_log.jsonl").read_text().splitlines()) == STEPS
    assert len(_val_rows(root, version)) == 2
    assert len(list(run.glob("events.out.tfevents.*"))) == 1
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step=2", "step=4"]


@pytest.mark.parametrize("version", ["cross12", "cross21"])
def test_checkpoints_cross_world_sizes(workspace, runs, version):
    """A one-process step=2/ resumed by 2 ranks (model=2), and a 2-rank
    (data=2) step=2/ resumed by one process, take the steps that one process
    resumed from one process's step=2/ takes. The 2-rank step=2/ holds the
    one-process state, so the steps after it are the uninterrupted run's."""
    root, _ = workspace
    _assert_same_checkpoint(_ckpt(root, "data2", 2), _ckpt(root, "one", 2), runs["init"],
                            runs["init"])
    source = {"cross12": "one", "cross21": "data2"}[version]
    _assert_same_checkpoint(_ckpt(root, version, STEPS), _ckpt(root, "resumed", STEPS),
                            _ckpt(root, source, 2), _ckpt(root, "one", 2))
    assert [r["step"] for r in runs[version]] == [3, 4]
    for got, want in zip(runs[version], runs["resumed"]):
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=RTOL, abs=ATOL), (k, got[k], v)


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_loader_yields_the_jax_shard(workspace, rank):
    """BucketedLoader(shard=(rank, 2)) yields the rows the JAX loader's
    shard=(rank, 2) yields for each global batch, with its n_real_global,
    over two epochs."""
    from fastspeech2_lightning_tpu.config import FastSpeech2Config as JConfig
    from fastspeech2_lightning_tpu.dataset import BucketedLoader as JBucketedLoader
    from fastspeech2_lightning_tpu.dataset import load_datasets as j_load_datasets
    from fastspeech2_lightning_tpu.text import lookuptables_from_config as j_lookups
    from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, load_datasets
    from fastspeech2_lightning_tpu_torch.text.lookups import lookuptables_from_config

    _, path = workspace
    cfg = FastSpeech2Config.from_file(path)
    jcfg = JConfig.model_validate(json.loads(path.read_text()))
    kwargs = dict(n_buckets=2, seed=3, max_mel_length=cfg.model.max_mel_length,
                  shard=(rank, 2))
    jl = JBucketedLoader(j_load_datasets(jcfg, *j_lookups(jcfg))[0], 4, **kwargs)
    tl = BucketedLoader(load_datasets(cfg, *lookuptables_from_config(cfg))[0], 4, **kwargs)
    n = 0
    for _ in range(2):
        for jb, tb in zip(jl, tl, strict=True):
            assert tb["basename"] == jb["basename"] and len(tb["basename"]) == 2
            assert tb["n_real_global"] == jb["n_real_global"]
            for key in ("text", "mel", "pitch", "energy", "attn_prior", "sample_weight"):
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
            n += 1
    assert n == 2 * len(tl) > 0


def test_a_batch_that_does_not_divide_over_the_data_ranks_raises(workspace):
    _, path = workspace
    messages = run_local(_batch_size_worker, 4, path, timeout_s=TIMEOUT_S)
    for message in messages:
        assert "batch_size=6" in message and "4 data ranks" in message


def _cli(cmd, env, cwd):
    return subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("launcher", ["fs2t", "torchrun"])
def test_train_cli_distributed_over_two_processes(workspace, runs, launcher):
    root, path = workspace
    version = f"cli_{launcher}"
    cfg = root / f"{version}.json"
    data = json.loads(path.read_text())
    data["training"]["logger"]["version"] = version
    cfg.write_text(json.dumps(data))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    train = ["-m", "fastspeech2_lightning_tpu_torch", "train", str(cfg), "--distributed",
             "--device", "cpu", "--max-steps", str(STEPS), "--model-parallel", "2"]
    if launcher == "fs2t":
        port = free_port()
        procs = [_cli([sys.executable, *train], {
            **env, "FS2T_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "FS2T_NUM_PROCESSES": "2",
            "FS2T_PROCESS_ID": str(i)}, root) for i in range(2)]
    else:
        procs = [_cli([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                       "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
                       *train], env, root)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{launcher} launch timed out")
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    assert _ckpt(root, version, STEPS).is_dir()
    assert "".join(outs).count(f"trained {STEPS} steps") == 1  # rank 0 alone reports
    _assert_same_checkpoint(_ckpt(root, version, STEPS), _ckpt(root, "one", STEPS),
                            runs["init"], runs["init"])
