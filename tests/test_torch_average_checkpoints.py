"""``average-checkpoints`` and ``export-checkpoint`` of the port against the
JAX package's, on the CPU.

Three JAX train states of a tiny f32 model (the init, moved by seeded noise;
the EMA, the BatchNorm statistics and the metrics differing as well) are
saved by the JAX ``save_checkpoint`` and, through ``convert``, by the port's.
The port's averages of the params, and of the EMA with ``use_ema``, equal
JAX's ``average_checkpoints`` converted to the port's layout within 1e-6
(the same float64 sums), for the newest two and all
three, listed in any order; a bf16 tree averages bit-equal. Buffers
(BatchNorm statistics, variance bins, positions) are the newest
checkpoint's, not averaged; ``metrics``, ``averaged_from`` and
``global_step`` match the JAX meta; the optimizer state is the newest's and
the EMA is dropped; a missing EMA raises in both. The CLI's usage errors and
``--last`` follow the JAX command. The averaged step directory serves.

``export-checkpoint`` writes a port ``step=N/`` as a standalone ``.ckpt``
that the JAX package's ``.ckpt`` loader and the port both load, with equal
durations and mels within 1e-5 of the mel's largest magnitude (f32 rounding
of two frameworks; 2.2e-6 measured), and the port's mel equal to the step
directory's; an orbax directory is a usage error."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
from fastspeech2_lightning_tpu.synthesis.api import Synthesizer as JSynthesizer
from fastspeech2_lightning_tpu.text import TextProcessor as JTextProcessor
from fastspeech2_lightning_tpu.training import checkpoint as jckpt
from fastspeech2_lightning_tpu.training.state import create_train_state
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.checkpoint import CheckpointError
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import state_dict_from_jax, train_state_from_jax
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.training import checkpoint as tckpt
from fastspeech2_lightning_tpu_torch.training.checkpoint import TrainSnapshot

from helpers import synthetic_batch, tiny_config, tiny_stats

torch.set_num_threads(2)
MONITOR = "validation/total_loss"
STEPS = (10, 20, 30)
LOOKUP = {"default": 0}
TEXTS = ["hello world, how are you today", "abc"]


def _adam_state(opt_state):
    """The optax ScaleByAdamState inside a chain's nested state tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for sub in opt_state if isinstance(opt_state, (tuple, list)) else ():
        found = _adam_state(sub)
        if found is not None:
            return found
    return None


def _moved(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(
            np.asarray(x).dtype), tree)


def _tensors(d):
    return None if d is None else {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _port_save(ckpt_dir, state, jcfg, stats, symbols, metrics):
    adam = _adam_state(state.opt_state)
    sd, ts = train_state_from_jax(state.params, adam.mu, adam.nu, adam.count, state.ema_params,
                                  state.batch_stats, state.constants, jcfg, stats)
    snap = TrainSnapshot(state_dict=_tensors(sd), mu=_tensors(ts["mu"]), nu=_tensors(ts["nu"]),
                         count=ts["count"], ema=_tensors(ts["ema"]), step=int(state.step),
                         epoch=0)
    cfg = FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())
    return tckpt.save_checkpoint(ckpt_dir, snap, cfg.to_dict(), stats.model_dump(mode="json"),
                                 LOOKUP, LOOKUP, symbols, metrics=metrics)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same three checkpoints saved by each package."""
    root = tmp_path_factory.mktemp("avg")
    jcfg = tiny_config(dtype="float32")
    jcfg.training.ema_decay = 0.9
    stats = tiny_stats()
    symbols = JTextProcessor(jcfg.text).symbols
    model = JFastSpeech2(config=jcfg, stats=stats, n_symbols=len(symbols), n_speakers=1,
                         n_languages=1)
    state = create_train_state(jcfg, model, jax.random.PRNGKey(0),
                               synthetic_batch(np.random.default_rng(0)))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    # durations of about 4 frames a symbol, so the synthesized mels are not empty
    params["variance_adaptor"]["duration_predictor"]["linear"]["bias"] = np.full(
        (1,), np.log(4.0), np.float32)
    rng = np.random.default_rng(1)
    out = {"jax": [], "port": [], "jcfg": jcfg, "stats": stats, "root": root,
           "symbols": symbols, "states": []}
    for i, step in enumerate(STEPS):
        p = _moved(params, rng, 0.05)
        s = state.replace(
            params=p, step=step, ema_params=_moved(p, rng, 0.01),
            batch_stats=jax.tree_util.tree_map(
                lambda x: np.abs(np.asarray(x) + rng.standard_normal(np.shape(x))).astype(
                    np.float32), state.batch_stats))
        metrics = {MONITOR: 3.0 - i}
        out["states"].append(s)
        out["jax"].append(jckpt.save_checkpoint(root / "jax", s, jcfg, stats, LOOKUP, LOOKUP,
                                                symbols, metrics=metrics))
        out["port"].append(_port_save(root / "port", s, jcfg, stats, symbols, metrics))
    return out


def _jax_average_as_port(trees, paths, out, use_ema):
    path = jckpt.average_checkpoints(paths, out, use_ema=use_ema)
    meta, arrays = jckpt.load_checkpoint(path)
    sd = state_dict_from_jax(arrays["params"], arrays.get("batch_stats"),
                             arrays.get("constants"), trees["jcfg"], trees["stats"])
    return meta, sd


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
@pytest.mark.parametrize("which", ["newest_two", "all_reversed"])
def test_averages_match_jax(trees, tmp_path, use_ema, which):
    pick = (lambda xs: xs[1:]) if which == "newest_two" else (lambda xs: xs[::-1])
    jmeta, want = _jax_average_as_port(trees, pick(trees["jax"]), tmp_path / "jax_avg", use_ema)
    out = tckpt.average_checkpoints(pick(trees["port"]), tmp_path / "port_avg", use_ema=use_ema)
    ckpt = torch.load(out / "model.ckpt", map_location="cpu", weights_only=True)
    got = ckpt["state_dict"]
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].numpy().dtype == np.asarray(value).dtype, name
        np.testing.assert_allclose(got[name].numpy(), value, rtol=0, atol=1e-6, err_msg=name)
    meta = tckpt.read_meta(out)
    assert meta["metrics"] == jmeta["metrics"] == {}
    assert meta["global_step"] == jmeta["global_step"] == STEPS[-1]
    assert meta["averaged_from"] == [str(p) for p in pick(trees["port"])]
    assert jmeta["averaged_from"] == [str(p) for p in pick(trees["jax"])]
    assert ckpt["global_step"] == STEPS[-1]
    # the optimizer state is the newest's; the EMA is dropped, as JAX drops ema_params
    state, newest = tckpt.load_train_state(out), tckpt.load_train_state(trees["port"][-1])
    assert state["ema"] is None and state["count"] == newest["count"]
    for name, value in newest["mu"].items():
        assert torch.equal(state["mu"][name], value) and torch.equal(state["nu"][name],
                                                                     newest["nu"][name])
    assert not list(out.parent.glob("*.tmp"))


def test_buffers_come_from_the_newest_checkpoint(trees, tmp_path):
    out = tckpt.average_checkpoints(trees["port"], tmp_path / "avg")
    got = torch.load(out / "model.ckpt", map_location="cpu", weights_only=True)["state_dict"]
    sds = [torch.load(p / "model.ckpt", map_location="cpu", weights_only=True)["state_dict"]
           for p in trees["port"]]
    buffers = [k for k in got if k.endswith(("running_mean", "running_var", "_bins",
                                             "num_batches_tracked", "inv_freq"))]
    assert any(k.endswith("running_var") for k in buffers)
    for name in buffers:
        assert torch.equal(got[name], sds[-1][name]), name
        if name.endswith("running_var"):
            assert not torch.equal(got[name], sds[0][name]), name
    name = "mel_linear.weight"
    mean = sum(sd[name].double() for sd in sds) / 3
    assert torch.equal(got[name], mean.float())


def test_bf16_leaves_average_bit_equal(trees, tmp_path):
    """Three bf16 trees: the mean of three is inexact, so the float64 sum,
    the division and the cast back must happen as JAX does them."""
    jpaths, ppaths = [], []
    for i, s in enumerate(trees["states"]):
        bf16 = s.replace(params=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                                       s.params), ema_params=None)
        jpaths.append(jckpt.save_checkpoint(tmp_path / "jax", bf16, trees["jcfg"],
                                            trees["stats"], LOOKUP, LOOKUP, trees["symbols"]))
        port = tckpt.average_checkpoints([trees["port"][i]], tmp_path / f"one{i}")
        ckpt = torch.load(port / "model.ckpt", map_location="cpu", weights_only=True)
        ckpt["state_dict"] = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                              for k, v in ckpt["state_dict"].items()}
        torch.save(ckpt, port / "model.ckpt")
        ppaths.append(port)
    _, arrays = jckpt.load_checkpoint(jckpt.average_checkpoints(jpaths, tmp_path / "javg"))
    want = state_dict_from_jax(arrays["params"], None, None, trees["jcfg"])
    out = tckpt.average_checkpoints(ppaths, tmp_path / "pavg")
    got = torch.load(out / "model.ckpt", map_location="cpu", weights_only=True)["state_dict"]
    names = list(tckpt.load_train_state(trees["port"][0])["mu"])  # the parameters
    assert len(names) > 20
    for name in names:
        assert got[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got[name].float().numpy(), want[name], err_msg=name)


def test_missing_ema_raises_in_both(tmp_path, trees):
    s = trees["states"][0].replace(ema_params=None)
    jpath = jckpt.save_checkpoint(tmp_path / "jax", s, trees["jcfg"], trees["stats"], LOOKUP,
                                  LOOKUP, trees["symbols"])
    ppath = _port_save(tmp_path / "port", s, trees["jcfg"], trees["stats"], trees["symbols"],
                       None)
    with pytest.raises(jckpt.CheckpointError, match="no ema_params"):
        jckpt.average_checkpoints([jpath], tmp_path / "javg", use_ema=True)
    with pytest.raises(CheckpointError, match="no ema_params"):
        tckpt.average_checkpoints([ppath], tmp_path / "pavg", use_ema=True)
    with pytest.raises(CheckpointError, match="no checkpoints"):
        tckpt.average_checkpoints([], tmp_path / "pavg")


def _port_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def test_cli_usage_errors_and_last(trees, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "step=3.tmp").mkdir()
    j = CliRunner().invoke(jax_app, ["average-checkpoints", str(empty / "nothing"), "-o",
                                     str(tmp_path / "x")])
    code, _, err = _port_cli(["average-checkpoints", str(empty / "nothing"), "-o",
                              str(tmp_path / "x")])
    assert code == j.exit_code == 2 and "does not exist" in err and "does not exist" in j.output
    (empty / "step=3.tmp").rmdir()
    j = CliRunner().invoke(jax_app, ["average-checkpoints", str(empty), "-o", str(tmp_path / "x")])
    code, _, err = _port_cli(["average-checkpoints", str(empty), "-o", str(tmp_path / "x")])
    want = f"No step=N checkpoints under {empty}"
    assert code == j.exit_code == 2 and want in err and want in j.output
    code, _, err = _port_cli(["average-checkpoints", str(empty)])
    assert code == 2 and "--output" in err
    code, out, _ = _port_cli(["average-checkpoints", str(trees["port"][0].parent), "--last", "2",
                              "-o", str(tmp_path / "last2"), "--no-use-ema"])
    assert code == 0 and out.strip() == f"Averaged 2 checkpoints -> {tmp_path / 'last2'}"
    assert tckpt.read_meta(tmp_path / "last2")["averaged_from"] == [
        str(p) for p in trees["port"][1:]]
    code, out, _ = _port_cli(["average-checkpoints", str(trees["port"][0].parent), "-n", "3",
                              "-o", str(tmp_path / "ema3"), "--use-ema"])
    assert code == 0 and "Averaged 3 checkpoints" in out


def test_the_averaged_checkpoint_serves(trees, tmp_path):
    out = tckpt.average_checkpoints(trees["port"], tmp_path / "avg", use_ema=True)
    syn = Synthesizer.from_checkpoint(out, device="cpu")
    assert syn.global_step == STEPS[-1]
    result = syn.synthesize(TEXTS)
    assert all(m.shape[0] > 0 and np.isfinite(m).all() for m in result.mels)
    with pytest.raises(ValueError, match="EMA"):
        Synthesizer.from_checkpoint(out, device="cpu", use_ema=True)


def test_export_checkpoint_loads_in_both_packages(trees, tmp_path):
    step_dir = trees["port"][-1]
    out = tmp_path / "nested" / "dir" / "model.ckpt"
    code, text, _ = _port_cli(["export-checkpoint", str(step_dir), "-o", str(out)])
    assert code == 0 and text.strip() == f"exported {step_dir} -> {out}"
    assert out.read_bytes() == (step_dir / "model.ckpt").read_bytes()
    want = JSynthesizer.from_checkpoint(out).synthesize(TEXTS)
    got = Synthesizer.from_checkpoint(out, device="cpu").synthesize(TEXTS)
    from_dir = Synthesizer.from_checkpoint(step_dir, device="cpu").synthesize(TEXTS)
    for j, p, d in zip(want.durations, got.durations, from_dir.durations):
        np.testing.assert_array_equal(p, j)
        np.testing.assert_array_equal(d, p)
    for j, p, d in zip(want.mels, got.mels, from_dir.mels):
        assert j.shape[0] > 0
        # f32 forwards of two frameworks: rounding grows with the mel's scale
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-5 * np.abs(j).max())
        np.testing.assert_array_equal(d, p)


def test_export_checkpoint_refuses_an_orbax_directory(trees, tmp_path):
    code, _, err = _port_cli(["export-checkpoint", str(trees["jax"][-1]), "-o",
                              str(tmp_path / "m.ckpt")])
    assert code == 2 and "orbax" in err and "fs2t export-checkpoint" in err
    assert not (tmp_path / "m.ckpt").exists()
    code, _, err = _port_cli(["export-checkpoint", str(tmp_path / "missing"), "-o",
                              str(tmp_path / "m.ckpt")])
    assert code == 2 and "does not exist" in err
    j = CliRunner().invoke(jax_app, ["export-checkpoint", str(trees["jax"][-1]), "-o",
                                     str(tmp_path / "j.ckpt")])
    assert j.exit_code == 0, j.output  # the JAX command's job
    json.dumps(torch.load(tmp_path / "j.ckpt", map_location="cpu",
                          weights_only=False)["hyper_parameters"]["config"])
