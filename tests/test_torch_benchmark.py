"""The port's ``benchmark`` command against the JAX package's, on the CPU.

On a tiny workspace the JAX package preprocessed: the batch the port times
is the JAX command's batch (the first of ``BucketedLoader(seed=0)`` without
the host-only keys, as the device step stages it), array for array; with the JAX command's initial weights
(``PRNGKey(0)``) converted to the port, the timed function's output equals
the JAX ``apply_fn``'s in both modes (f32, rel-L2 1e-5: the two frameworks
sum in different orders); the printed line has the JAX line's fields; the
profiler trace is JSON. ``check_mfu`` refuses an MFU above 100 %, and
``count_flops`` counts kernel A (the op ``fs2t::attention_fwd``, by its FLOP
formula) and a launch of A′ (its wrapper's ``flops`` counter) as
FlopCounterMode counts the plain version, so the card's total equals the
CPU's. Without a card and without ``--device cpu`` the command raises."""

import contextlib
import io
import json
import re

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu.dataset import HOST_ONLY_KEYS
from fastspeech2_lightning_tpu.dataset import BucketedLoader as JBucketedLoader
from fastspeech2_lightning_tpu.dataset import load_datasets as j_load_datasets
from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
from fastspeech2_lightning_tpu.preprocessing.stats import load_stats as j_load_stats
from fastspeech2_lightning_tpu.text import TextProcessor as JTextProcessor
from fastspeech2_lightning_tpu.text import lookuptables_from_config as j_lookups
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import state_dict_from_jax
from fastspeech2_lightning_tpu_torch.ops import attention
from fastspeech2_lightning_tpu_torch.training.step import DEVICE_KEYS
from fastspeech2_lightning_tpu_torch.utils import benchmarking
from fastspeech2_lightning_tpu_torch.utils.benchmarking import (
    H100_PEAK_FLOPS,
    check_mfu,
    count_flops,
    prepare_benchmark,
    time_chained,
    time_pipelined,
)

from helpers import make_training_workspace

torch.set_num_threads(2)
CPU = torch.device("cpu")
LINE = re.compile(
    r"Average forward pass for (\w+) duration after (\d+) repetitions: ([\d.]+) ms "
    r"Standard Deviation: ([\d.]+) \(best ([\d.]+) ms, ([\d.]+) TFLOP/call, MFU ([\d.]+)%; "
    r"forced-completion chained timing\)")
# the JAX command's batch fields outside the port's DEVICE_KEYS: neither model
# reads them (the synthesis writers scale durations by duration_control)
LEFT_BEHIND = {"duration_control"}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    jcfg = make_training_workspace(root, n_utts=7, model_overrides={"dtype": "float32"},
                                   batch_size=3, bucket_count=1)
    path = root / "config.json"
    path.write_text(json.dumps(jcfg.model_checkpoint_dump()))
    return jcfg, path


@pytest.fixture(scope="module")
def jax_side(workspace):
    """The JAX command's batch, model and weights (``cli/__init__.py:419-455``)."""
    jcfg, _ = workspace
    lang2id, speaker2id = j_lookups(jcfg)
    train_ds, _ = j_load_datasets(jcfg, lang2id, speaker2id)
    batch = next(iter(JBucketedLoader(train_ds, jcfg.training.batch_size, seed=0,
                                      max_mel_length=jcfg.model.max_mel_length)))
    batch = {k: v for k, v in batch.items() if k not in HOST_ONLY_KEYS}
    stats = j_load_stats(jcfg.preprocessing.save_dir / "stats.json")
    model = JFastSpeech2(config=jcfg, stats=stats, n_symbols=len(JTextProcessor(jcfg.text).symbols),
                         n_speakers=max(len(speaker2id), 1), n_languages=max(len(lang2id), 1))
    variables = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           batch, deterministic=True)

    @jax.jit
    def outputs(variables, batch):
        return {mode: model.apply(variables, batch, inference=mode == "inference",
                                  deterministic=True,
                                  max_target_len=(jcfg.model.max_mel_length
                                                  if mode == "inference" else None))["output"]
                for mode in ("training", "inference")}

    return dict(batch=batch, variables=variables, stats=stats,
                outputs={k: np.asarray(v) for k, v in outputs(variables, batch).items()})


def _port_config(workspace):
    return FastSpeech2Config.from_file(workspace[1])


def test_the_timed_batch_is_the_jax_commands_batch(workspace, jax_side):
    bench = prepare_benchmark(_port_config(workspace), "training", CPU)
    given = {k: v for k, v in jax_side["batch"].items() if v is not None}
    want = {k: v for k, v in given.items() if k in DEVICE_KEYS}
    assert sorted(bench.batch) == sorted(want)
    assert not set(given) - set(want) - LEFT_BEHIND, sorted(set(given) - set(want))
    for key, value in want.items():
        np.testing.assert_array_equal(bench.batch[key].numpy(), value, err_msg=key)
    assert bench.carry_key == "pitch"


@pytest.mark.parametrize("mode", ["training", "inference"])
def test_the_timed_forward_equals_jax_apply_fn(workspace, jax_side, mode):
    bench = prepare_benchmark(_port_config(workspace), mode, CPU)
    v = jax_side["variables"]
    sd = state_dict_from_jax(v["params"], v.get("batch_stats"), v.get("constants"),
                             workspace[0], jax_side["stats"])
    bench.model.load_state_dict({k: torch.tensor(np.asarray(a)) for k, a in sd.items()},
                                strict=True)
    out, carry = bench.fn(bench.batch, torch.zeros(()))
    want = jax_side["outputs"][mode]
    got = out.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    assert float(carry) == pytest.approx(float(got.reshape(-1)[:4].sum()) * 1e-12)


def _port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().strip().splitlines()


def test_the_printed_line_has_the_jax_lines_fields(workspace, tmp_path):
    _, path = workspace
    reps = ["--warmup-reps", "1", "--repetitions", "2"]
    jline = CliRunner().invoke(jax_app, ["benchmark", str(path), "--benchmark-type",
                                         "inference", *reps]).output.strip().splitlines()[-1]
    lines = _port_cli(["benchmark", str(path), "--benchmark-type", "inference", *reps,
                       "--device", "cpu", "--profile-dir", str(tmp_path / "prof")])
    j, p = LINE.fullmatch(jline), LINE.fullmatch(lines[-1])
    assert j is not None, jline
    assert p is not None, lines[-1]
    assert p.group(1, 2) == j.group(1, 2) == ("inference", "2")
    mean, std, best, tflop, mfu = map(float, p.groups()[2:])
    assert best <= mean and std >= 0 and tflop >= 0 and 0 <= mfu <= 100
    trace = tmp_path / "prof" / "trace.json"
    assert lines[0] == f"Wrote profiler trace to {trace}"
    assert json.loads(trace.read_text())["traceEvents"]


def test_check_mfu_refuses_above_100_percent():
    assert check_mfu(H100_PEAK_FLOPS / 4, 1.0) == pytest.approx(0.25)
    assert check_mfu(0.0, 1.0) == 0.0
    with pytest.raises(SystemExit, match="BENCH INVALID"):
        check_mfu(H100_PEAK_FLOPS * 1.01, 1.0)


@pytest.mark.parametrize("shape", [(2, 2, 33, 64), (1, 2, 40, 128)])
def test_count_flops_counts_a_launch_as_the_plain_version(shape):
    B, H, T, dh = shape
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    bias = torch.zeros(B, T)
    fwd = attention.attention_fwd_flops(B, H, T, dh)
    bwd = attention.attention_bwd_flops(B, H, T, dh)
    assert count_flops(attention.attention_reference, q, k, v, bias, 0.125) == fwd
    # the CPU wrapper runs the plain version and leaves the counter alone
    assert count_flops(attention.attention_fwd, q, k, v, bias, 0.125) == fwd
    seed = torch.zeros(1, dtype=torch.int32)
    assert count_flops(attention.attention_bwd_reference, q, k, v, bias, seed, 0.0, 0.125,
                       do) == bwd

    def launch(counter, flops):  # what A′'s wrapper does where it launches its kernel
        counter.flops += flops
        return torch.empty(0)

    assert count_flops(launch, attention.attention_bwd, bwd) == bwd
    # A is the op fs2t::attention_fwd, counted by its FLOP formula on either
    # device: it keeps no counter of its own
    assert not hasattr(attention.attention_fwd, "flops")


def test_training_mode_counts_the_attention_products(workspace):
    bench = prepare_benchmark(_port_config(workspace), "training", CPU)
    flops = count_flops(bench.fn, bench.batch, torch.zeros(()))
    B, L = bench.batch["text"].shape
    T = bench.batch["mel"].shape[1]
    m = _port_config(workspace).model
    att = (m.encoder.layers * attention.attention_fwd_flops(B, m.encoder.heads, L,
                                                            m.encoder.input_dim // m.encoder.heads)
           + m.decoder.layers * attention.attention_fwd_flops(B, m.decoder.heads, T,
                                                              m.decoder.input_dim // m.decoder.heads))
    assert flops > att > 0


def test_timing_loops_run_their_trials(workspace):
    bench = prepare_benchmark(_port_config(workspace), "inference", CPU)
    times = time_chained(bench.fn, [bench.batch], reps=2, trials=3, warmup=1)
    assert len(times) == 3 and all(t > 0 for t in times)
    times = time_pipelined(lambda b: bench.fn(b, torch.zeros(()))[1], [bench.batch], reps=2,
                           trials=2, warmup=1)
    assert len(times) == 2 and all(t > 0 for t in times)
    with pytest.raises(ValueError, match="benchmark_type"):
        prepare_benchmark(_port_config(workspace), "serving", CPU)
    assert benchmarking.BENCHMARK_TYPES == ("training", "inference")


def test_benchmark_without_a_card_raises(workspace):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["benchmark", str(workspace[1])])
