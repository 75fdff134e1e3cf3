"""The port's checkpoint rules against the JAX package's, on the CPU.

The same meta and arrays go through JAX ``check_and_upgrade_checkpoint`` and
the port's copy: a 1.1 character model with a permuted symbol table gets the
same remapped embedding bit for bit, a missing ``model_info`` counts as 1.0,
and a newer version, a pfs model before 1.2, a wrong name and an unknown
symbol raise alike. A stubbed JAX model exported to a 1.1 ``.ckpt``
synthesizes the JAX package's mel in the port (f32, max-abs 1e-5), and a
"9.9" one is refused by both. ``latest_checkpoint`` and
``prune_checkpoints`` of both packages leave the same survivors of identical
trees of ``step=N`` dirs (metrics present and absent, ``.tmp`` dirs, dirs
without ``meta.json``). A save killed before its rename leaves nothing that
``latest_checkpoint`` picks; an async save stores the values from before a
change made right after ``save()``; a failing async save re-raises on
``wait()``."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.synthesis.api import Synthesizer as JaxSynthesizer
from fastspeech2_lightning_tpu.testing import get_stubbed_model, stub_config
from fastspeech2_lightning_tpu.training import checkpoint as jckpt
from fastspeech2_lightning_tpu_torch.checkpoint import (
    EMBEDDING,
    CheckpointError,
    check_and_upgrade_checkpoint,
)
from fastspeech2_lightning_tpu_torch.config import TrainingConfig
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.training import checkpoint as tckpt
from fastspeech2_lightning_tpu_torch.training.state import AdamWNoam

torch.set_num_threads(2)
MONITOR = "validation/total_loss"
SYMBOLS = ["\x80", "a", "b", "c", "d", "e"]


def _meta(version="1.1", name="FastSpeech2", level="characters", symbols=None):
    meta = {"config": {"model": {"target_text_representation_level": level}},
            "symbols": list(symbols if symbols is not None else SYMBOLS[::-1])}
    if version is not None:
        meta["model_info"] = {"name": name, "version": version}
    return meta


CASES = {
    "permuted_1.1": (_meta(), None),
    "missing_model_info": (_meta(version=None), None),
    "subset_1.0": (_meta(version="1.0", symbols=["c", "a", "\x80"]), None),
    "current_1.2": (_meta(version="1.2"), None),
    "newer_9.9": (_meta(version="9.9"), ValueError),
    "pfs_1.1": (_meta(level="phonological_features"), ValueError),
    "wrong_name": (_meta(name="HiFiGAN"), TypeError),
    "unknown_symbol": (_meta(symbols=["\x80", "z"]), "CheckpointError"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_version_gate_and_symbol_remap_match_jax(case):
    meta, raises = CASES[case]
    rows = len(meta["symbols"])
    emb = np.random.default_rng(0).standard_normal((rows, 4)).astype(np.float32)

    def jax_side():
        return jckpt.check_and_upgrade_checkpoint(
            copy.deepcopy(meta), {"params": {"text_input_layer": {"embedding": emb.copy()}}},
            SYMBOLS)

    def port_side():
        return check_and_upgrade_checkpoint(
            copy.deepcopy(meta), {EMBEDDING: torch.from_numpy(emb.copy())}, SYMBOLS)

    if raises is not None:
        for side in (jax_side, port_side):
            with pytest.raises(Exception) as info:
                side()
            assert raises in (type(info.value), type(info.value).__name__), info.value
        return
    jmeta, jarrays = jax_side()
    tmeta, tsd = port_side()
    assert tmeta["model_info"] == jmeta["model_info"]
    want = np.asarray(jarrays["params"]["text_input_layer"]["embedding"])
    got = tsd[EMBEDDING].numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case in ("permuted_1.1", "missing_model_info"):
        assert not np.array_equal(got, emb)  # the rows moved


@pytest.fixture(scope="module")
def old_ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("old")
    _, orbax_dir = get_stubbed_model(tmp / "model", config=stub_config(dtype="float32"))
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp / "model.ckpt")
    out = {}
    for version in ("1.1", "9.9"):
        data = torch.load(ckpt, map_location="cpu", weights_only=False)
        data["model_info"] = {"name": "FastSpeech2", "version": version}
        out[version] = tmp / f"model_{version}.ckpt"
        torch.save(data, out[version])
    return out


def test_a_1_1_ckpt_synthesizes_the_jax_mel_and_9_9_is_refused(old_ckpts):
    texts = ["hello world, how are you today", "abc"]
    want = JaxSynthesizer.from_checkpoint(old_ckpts["1.1"]).synthesize(texts)
    got = Synthesizer.from_checkpoint(old_ckpts["1.1"], device="cpu").synthesize(texts)
    for j, p in zip(want.durations, got.durations):
        np.testing.assert_array_equal(p, j)
    for j, p in zip(want.mels, got.mels):
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)
    assert want.mels[0].size > 0
    for load in (lambda p: JaxSynthesizer.from_checkpoint(p),
                 lambda p: Synthesizer.from_checkpoint(p, device="cpu")):
        with pytest.raises(ValueError, match="newer version"):
            load(old_ckpts["9.9"])
    with pytest.raises(ValueError, match="EMA"):
        Synthesizer.from_checkpoint(old_ckpts["1.1"], device="cpu", use_ema=True)
    orbax_like = old_ckpts["1.1"].parent / "model" / "orbax_like"
    orbax_like.mkdir(parents=True)
    with pytest.raises(ValueError, match="export-checkpoint"):
        Synthesizer.from_checkpoint(orbax_like, device="cpu")


def _tree(root: Path) -> Path:
    """step=N dirs with and without metrics, two .tmp dirs (one with a
    meta.json), a dir without meta.json and one whose meta is not JSON."""
    root.mkdir(parents=True)
    metrics = {1: 3.0, 2: None, 3: 2.5, 5: 2.5, 7: None, 8: 4.0, 10: 1.0, 12: None}
    for step, m in metrics.items():
        d = root / f"step={step}"
        d.mkdir()
        (d / "meta.json").write_text(json.dumps(
            {"global_step": step, "metrics": {} if m is None else {MONITOR: m}}))
    (root / "step=14.tmp").mkdir()
    (root / "step=13.tmp").mkdir()
    (root / "step=13.tmp" / "meta.json").write_text(json.dumps(
        {"global_step": 13, "metrics": {MONITOR: 0.5}}))
    (root / "step=15").mkdir()
    (root / "step=4").mkdir()
    (root / "step=4" / "meta.json").write_text("{not json")
    return root


@pytest.mark.parametrize("keep", [1, 2, 3, 20])
def test_latest_and_prune_leave_the_jax_survivors(tmp_path, keep):
    j_root, t_root = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert jckpt.latest_checkpoint(j_root).name == tckpt.latest_checkpoint(t_root).name == "step=12"
    jckpt.prune_checkpoints(j_root, keep, MONITOR)
    tckpt.prune_checkpoints(t_root, keep, MONITOR)
    survivors = sorted(p.name for p in t_root.iterdir())
    assert survivors == sorted(p.name for p in j_root.iterdir())
    assert "step=15" in survivors and "step=14.tmp" in survivors
    assert jckpt.latest_checkpoint(j_root).name == tckpt.latest_checkpoint(t_root).name
    assert tckpt.latest_checkpoint(tmp_path / "absent") is None


def _tiny_run():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = AdamWNoam(list(model.named_parameters()), TrainingConfig())
    grads = [torch.randn_like(p) for p in opt.params]
    opt.step(grads)
    ema = [p.detach().clone() * 0.5 for p in opt.params]
    return model, opt, ema


ARGS = ({"model": {}}, None, {}, {}, SYMBOLS)


def test_a_save_killed_before_its_rename_is_never_picked(tmp_path, monkeypatch):
    model, opt, ema = _tiny_run()
    snap = tckpt.take_snapshot(model, opt, ema, step=3, epoch=1)
    tckpt.save_checkpoint(tmp_path, snap, *ARGS)

    def killed(self, target):
        raise KeyboardInterrupt("killed between the .tmp write and the rename")

    monkeypatch.setattr(Path, "rename", killed)
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_checkpoint(tmp_path, tckpt.take_snapshot(model, opt, ema, 5, 1), *ARGS)
    monkeypatch.undo()
    assert (tmp_path / "step=5.tmp" / "meta.json").exists()
    assert tckpt.latest_checkpoint(tmp_path).name == "step=3"
    tckpt.save_checkpoint(tmp_path, tckpt.take_snapshot(model, opt, ema, 5, 2), *ARGS)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step=3", "step=5"]
    assert tckpt.read_meta(tmp_path / "step=5")["epoch"] == 2


def test_an_async_save_stores_the_values_from_before_a_change(tmp_path):
    model, opt, ema = _tiny_run()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mu, ema_before = [m.clone() for m in opt.mu], [e.clone() for e in ema]
    writer = tckpt.AsyncCheckpointWriter()
    writer.save(tmp_path, model, opt, ema, 7, 2, *ARGS, metrics={MONITOR: 1.5},
                keep_top_k=1, monitor=MONITOR)
    with torch.no_grad():  # the next step's in-place updates
        for p, m, e in zip(opt.params, opt.mu, ema):
            p.add_(1.0)
            m.add_(1.0)
            e.add_(1.0)
        model[1].running_mean.add_(1.0)
    opt.count += 1
    writer.wait()
    sd = torch.load(tmp_path / "step=7" / "model.ckpt", weights_only=True)["state_dict"]
    for k, v in before.items():
        assert torch.equal(sd[k], v), k
    ts = tckpt.load_train_state(tmp_path / "step=7")
    assert ts["count"] == 1
    for name, m, e in zip(opt.names, mu, ema_before):
        assert torch.equal(ts["mu"][name], m) and torch.equal(ts["ema"][name], e), name
    meta = tckpt.read_meta(tmp_path / "step=7")
    assert (meta["global_step"], meta["epoch"], meta["metrics"]) == (7, 2, {MONITOR: 1.5})
    assert meta["array_keys"] == ["ema_params", "opt_state", "params"]


def test_a_failing_async_save_reraises_on_wait(tmp_path):
    model, opt, ema = _tiny_run()
    blocked = tmp_path / "not_a_dir"
    blocked.write_text("a file where the checkpoint directory should be")
    writer = tckpt.AsyncCheckpointWriter()
    writer.save(blocked, model, opt, None, 1, 0, *ARGS)
    with pytest.raises(CheckpointError, match="async checkpoint save failed"):
        writer.wait()
    writer.wait()  # the failure is reported once
