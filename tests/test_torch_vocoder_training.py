"""The PyTorch port's vocoder trainer (training/vocoder.py, models/hifigan.py's
``init_random_hifigan`` and ``HiFiGANGenerator``, preprocessing/features.py's
``mel_spectrogram_torch``) against the JAX package's ``training/vocoder.py``.

The same seed gives the JAX generator's weights bit for bit; the
discriminators cross over through ``discriminators_from_jax``. From the
same state and batch one f32 D+G step gives JAX's losses within 1e-5
relative and each parameter's gradient within rel-L2 1e-4 (JAX's gradients
are read off its Adam state after the step: mu = (1 - b1) * grad); three
steps keep the losses within 1e-4. Parameters after a step can differ by up
to about 2 * lr an element: Adam's first update moves a parameter by about
lr * sign(grad), and a gradient near 0 can take another sign in the other
framework.

The generator of these steps starts at weights of std 0.1
(``init_random_hifigan``'s draws times GEN_SCALE), whose output peaks near
0.06. At the init's 0.02 it peaks near 3e-6: every mel bin of the fake sits
at the LOG_CLIP floor, and on the real crop's zero padding the feature
matching compares D's features of a near-silent fake with those of
silence down to rounding level, where the sign of |real - fake|, and then
Adam's first step, is rounding's choice in each framework.

A bf16 step (parameters cast before the weight norm) gives JAX's bf16
losses within 2e-2. Two gloo ranks (``parallel.launch.run_local``, the rank
functions in ``torch_dp_workers.py``) with one row each of the same three
batches give the one-process losses and JAX's within rtol 2e-4 / atol 2e-5
(JAX's ``test_vocoder_step_data_parallel_matches_single``), and the
one-process step-1 update tensor by tensor within rel-L2 1e-3 on the
elements whose gradient is not zero to rounding (``parallel.launch.settled``);
skipping the generator's gradient average is refused by that check.
``train_vocoder(data_parallel=2)`` under a process group logs the one-process
run's losses, writes ``step=N/`` once and resumes at world 2; without a
launcher it raises, naming torchrun. The crop loader yields JAX's batches for the same
workspace and seed, the learning rate is optax's schedule, a save and resume
continue bit for bit, and ``vocoder.npz`` crosses between the packages both
ways."""

import dataclasses
import json
import signal
import types
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastspeech2_lightning_tpu.models import hifigan as jh
from fastspeech2_lightning_tpu.models import hifigan_discriminators as jd
from fastspeech2_lightning_tpu.preprocessing.features import (
    mel_spectrogram_jax,
    mel_spectrogram_numpy,
)
from fastspeech2_lightning_tpu.training import vocoder as jv
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import (
    discriminators_from_jax,
    hifigan_state_from_jax,
)
from fastspeech2_lightning_tpu_torch.models import hifigan as ph
from fastspeech2_lightning_tpu_torch.models import hifigan_discriminators as pd
from fastspeech2_lightning_tpu_torch.preprocessing.features import mel_spectrogram_torch
from fastspeech2_lightning_tpu_torch.parallel.launch import run_local, settled, update_errors
from fastspeech2_lightning_tpu_torch.training import vocoder as pv
from fastspeech2_lightning_tpu_torch.training.checkpoint import latest_checkpoint

import torch_dp_workers
from helpers import make_training_workspace

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

DISC = dict(periods=(2, 3), mpd_channels=(4, 8), msd_channels=(8, 8, 16),
            msd_groups=(1, 4, 4), msd_strides=(1, 2, 2), msd_kernels=(15, 41, 41), n_scales=2)
GEN = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),), n_mels=20)
J_GEN, P_GEN = jh.HiFiGANConfig(**GEN), ph.HiFiGANConfig(**GEN)
J_DISC, P_DISC = jd.DiscriminatorConfig(**DISC), pd.DiscriminatorConfig(**DISC)
LR = 2e-4
GEN_SCALE = 5.0


class _Audio:
    input_sampling_rate = 22050
    output_sampling_rate = 22050
    n_fft = 1024
    fft_window_size = 1024
    fft_hop_size = 256
    n_mels = 20
    f_min = 0.0
    f_max = 8000.0
    spec_type = "mel-librosa"


A = _Audio()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch(seed: int, F: int = 8) -> dict:
    """Two crops: a chord with noise, and a noisy tone whose second half is
    zeros (a short utterance's padded crop: all-zero STFT frames). The noise
    keeps every mel bin of the signal well above the LOG_CLIP floor: on a
    pure tone the far bins hold only the FFT's f32 rounding (about 1e-5 of
    the peak, the floor's size), where d log(x) = dx / x turns each
    framework's rounding into a different gradient."""
    rng = np.random.default_rng(seed)
    t = np.arange(F * 256) / 22050.0
    a = 0.3 * np.sin(2 * np.pi * (220.0 + 40 * seed) * t) + 0.1 * np.sin(2 * np.pi * 660.0 * t)
    a = a + 0.02 * rng.standard_normal(t.size)
    b = 0.3 * np.sin(2 * np.pi * 330.0 * t) + 0.02 * rng.standard_normal(t.size)
    b[t.size // 2:] = 0.0
    wav = np.stack([a, b]).astype(np.float32)
    mel = np.stack([mel_spectrogram_numpy(w, 22050, 1024, 256, 1024, 20, 0.0, 8000.0).T[:F]
                    for w in wav]).astype(np.float32)
    return {"mel": mel, "wav": wav}


def _tc(dtype="float32", **kw):
    return dict(batch_size=2, frames_per_crop=8, learning_rate=LR, seed=0, compute_dtype=dtype,
                **kw)


def _host(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), jax.device_get(tree))


def _port_state(jstate0) -> pv.VocoderState:
    """The port's state on the JAX state's weights."""
    st = pv.create_vocoder_state(P_GEN, P_DISC, pv.VocoderTrainingConfig(**_tc()), device="cpu")
    st.gen.load_state_dict({k: torch.tensor(v) for k, v in
                            hifigan_state_from_jax(jstate0["gen"], P_GEN).items()})
    st.disc.load_state_dict({k: torch.tensor(v) for k, v in
                             discriminators_from_jax(jstate0["disc"]).items()})
    return st


def _to_torch(batch) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX: the initial state, three f32 steps (losses, states) and one bf16
    step, on batches 0, 1, 2."""
    tc = jv.VocoderTrainingConfig(**_tc())
    state, opt_g, opt_d = jv.create_vocoder_state(J_GEN, J_DISC, tc)
    state["gen"] = jax.tree_util.tree_map(lambda x: x * GEN_SCALE, state["gen"])
    state0 = _host(state)
    step_fn = jv.make_vocoder_train_step(J_GEN, J_DISC, tc, A, opt_g, opt_d)
    losses, states = [], []
    for i in range(3):
        state, lo = step_fn(state, _batch(i))
        losses.append({k: float(v) for k, v in lo.items()})
        states.append(_host(state))
    tcb = jv.VocoderTrainingConfig(**_tc("bfloat16"))
    sb, og, od = jv.create_vocoder_state(J_GEN, J_DISC, tcb)
    sb["gen"] = jax.tree_util.tree_map(lambda x: x * GEN_SCALE, sb["gen"])
    _, lb = jv.make_vocoder_train_step(J_GEN, J_DISC, tcb, A, og, od)(sb, _batch(0))
    return dict(state0=state0, losses=losses, states=states,
                bf16={k: float(v) for k, v in lb.items()})


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    st = _port_state(jax_runs["state0"])
    step = pv.make_vocoder_train_step(P_GEN, P_DISC, pv.VocoderTrainingConfig(**_tc()), A)
    losses, grads = [], None
    for i in range(3):
        losses.append({k: float(v) for k, v in step(st, _to_torch(_batch(i))).items()})
        if i == 0:
            grads = {
                "gen": {k: p.grad.clone() for k, p in st.gen.named_parameters()},
                "disc": {k: p.grad.clone() for k, p in st.disc.named_parameters()},
            }
            params1 = {"gen": {k: p.detach().clone() for k, p in st.gen.named_parameters()},
                       "disc": {k: p.detach().clone() for k, p in st.disc.named_parameters()}}
    return dict(losses=losses, grads=grads, params1=params1, state=st)


# ---------------------------------------------------------------------------
# weights, mel, schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["tiny", "v1"])
def test_init_random_hifigan_bit_equal(which):
    jcfg = J_GEN if which == "tiny" else jh.HiFiGANConfig()
    pcfg = P_GEN if which == "tiny" else ph.HiFiGANConfig()
    want = hifigan_state_from_jax(jax.device_get(jh.init_random_hifigan(jcfg, seed=3)), jcfg)
    got = ph.init_random_hifigan(pcfg, seed=3)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    gen = ph.HiFiGANGenerator(pcfg, got, device="cpu")
    assert set(gen.state_dict()) == set(want)


def test_generator_forward_matches_jax():
    sd = ph.init_random_hifigan(P_GEN, seed=1)
    gen = ph.HiFiGANGenerator(P_GEN, sd, device="cpu")
    mel = _batch(0)["mel"]
    want = np.asarray(jh.hifigan_generator(jh.init_random_hifigan(J_GEN, seed=1),
                                           jnp.asarray(mel), J_GEN))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 8 * 256)
    assert np.abs(got - want).max() <= 1e-5


def _mels(wav):
    jm = mel_spectrogram_jax(jnp.asarray(wav), 22050, 1024, 256, 1024, 20, 0.0, 8000.0)
    pm = mel_spectrogram_torch(torch.from_numpy(wav), 22050, 1024, 256, 1024, 20, 0.0, 8000.0)
    return np.asarray(jm), pm


@pytest.mark.parametrize("htk", [False, True], ids=["slaney", "htk"])
def test_mel_spectrogram_torch_matches_jax(htk):
    wav = _batch(1)["wav"]
    jm = mel_spectrogram_jax(jnp.asarray(wav), 22050, 1024, 256, 1024, 20, 0.0, 8000.0, htk=htk)
    pm = mel_spectrogram_torch(torch.from_numpy(wav), 22050, 1024, 256, 1024, 20, 0.0, 8000.0,
                               htk=htk)
    assert pm.dtype == torch.float32 and tuple(pm.shape) == jm.shape == (2, 20, 9)
    assert _rel(pm.numpy(), jm) <= 1e-5


def test_mel_l1_gradient_matches_jax():
    """The gradient of the mel L1 through |rfft| stays finite on all-zero
    frames (the padded crop, and a crop of zeros alone) and equals
    jax.grad's."""
    z = torch.zeros(1, 2048, requires_grad=True)
    mz = mel_spectrogram_torch(z, 22050, 1024, 256, 1024, 20, 0.0, 8000.0)
    assert torch.equal(mz, torch.full_like(mz, float(np.log(np.float32(1e-5)))))
    torch.mean(torch.abs(mz - 1.0)).backward()
    assert torch.equal(z.grad, torch.zeros_like(z))
    batch = _batch(2)
    wav, target = batch["wav"], batch["mel"].transpose(0, 2, 1)[..., :8]

    def loss_jax(w):
        m = mel_spectrogram_jax(w, 22050, 1024, 256, 1024, 20, 0.0, 8000.0)[..., :8]
        return jnp.mean(jnp.abs(m - target))

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(wav * 0.9)))
    w = torch.from_numpy(wav * 0.9).requires_grad_(True)
    m = mel_spectrogram_torch(w, 22050, 1024, 256, 1024, 20, 0.0, 8000.0)[..., :8]
    torch.mean(torch.abs(m - torch.from_numpy(target))).backward()
    got = w.grad.numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_learning_rate_is_optax_schedule():
    tc = pv.VocoderTrainingConfig()
    sched = optax.exponential_decay(tc.learning_rate, transition_steps=tc.lr_decay_steps,
                                    decay_rate=tc.lr_decay)
    for k in (0, 1, 999, 1000, 2500):
        want = float(sched(k))
        assert abs(pv.learning_rate(tc, k) - want) <= 1e-7 * want, k


# ---------------------------------------------------------------------------
# the D+G step
# ---------------------------------------------------------------------------


def _jax_grads(state_after_first_step):
    """JAX's first-step gradients, read off its Adam state: mu = (1 - b1) * grad."""
    b1 = 0.8
    return {
        "gen": hifigan_state_from_jax(jax.tree_util.tree_map(
            lambda m: m / (1 - b1), state_after_first_step["g_opt"][0].mu), P_GEN),
        "disc": discriminators_from_jax(jax.tree_util.tree_map(
            lambda m: m / (1 - b1), state_after_first_step["d_opt"][0].mu)),
    }


def test_first_step_losses_and_gradients_match_jax(jax_runs, port_runs):
    for k in pv.LOSS_KEYS:
        want, got = jax_runs["losses"][0][k], port_runs["losses"][0][k]
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    want = _jax_grads(jax_runs["states"][0])
    for side in ("gen", "disc"):
        got = port_runs["grads"][side]
        assert set(got) == set(want[side])
        for k in want[side]:
            rel = _rel(got[k].numpy(), want[side][k])
            assert rel <= 1e-4, (side, k, rel)


def test_first_step_parameters_match_jax(jax_runs, port_runs):
    """Within 2 * lr an element (Adam's first update is about lr * sign(grad),
    and a gradient near 0 may take either sign), and within rel-L2 1e-3."""
    s1 = jax_runs["states"][0]
    for side, want in (("gen", hifigan_state_from_jax(s1["gen"], P_GEN)),
                       ("disc", discriminators_from_jax(s1["disc"]))):
        got = port_runs["params1"][side]
        for k in want:
            d = np.abs(got[k].numpy() - want[k]).max()
            assert d <= 2 * LR + 1e-6, (side, k, d)
        flat_g = np.concatenate([got[k].numpy().ravel() for k in want])
        flat_w = np.concatenate([want[k].ravel() for k in want])
        assert _rel(flat_g, flat_w) <= 1e-3


def test_three_steps_match_jax(jax_runs, port_runs):
    for i in range(3):
        for k in pv.LOSS_KEYS:
            want, got = jax_runs["losses"][i][k], port_runs["losses"][i][k]
            assert abs(got - want) <= 1e-4 * abs(want), (i, k, got, want)
    assert port_runs["state"].step == 3
    assert all(g["step"] == 3 for g in port_runs["state"].opt_g.state.values())


def test_bf16_step_matches_jax_bf16(jax_runs):
    st = _port_state(jax_runs["state0"])
    tc = pv.VocoderTrainingConfig(**_tc("bfloat16"))
    got = pv.make_vocoder_train_step(P_GEN, P_DISC, tc, A)(st, _to_torch(_batch(0)))
    for k in pv.LOSS_KEYS:
        want = jax_runs["bf16"][k]
        assert abs(float(got[k]) - want) <= 2e-2 * abs(want), (k, float(got[k]), want)
    # parameters and optimizer state stay f32
    for p in list(st.gen.parameters()) + list(st.disc.parameters()):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for s in st.opt_g.state.values():
        assert s["exp_avg"].dtype == torch.float32


def test_generator_pass_leaves_no_discriminator_gradient(jax_runs):
    """D's gradients after a step are its own update's: the G pass adds
    nothing (the same D gradient as a D-only backward)."""
    st = _port_state(jax_runs["state0"])
    batch = _to_torch(_batch(0))
    with torch.no_grad():
        fake = st.gen(batch["mel"])
    s_all, _ = pd.discriminator_forward(st.disc, torch.cat([batch["wav"], fake]))
    loss = 0.0
    for s in s_all:
        loss = loss + torch.mean((s[:2] - 1.0) ** 2) + torch.mean(s[2:] ** 2)
    want = torch.autograd.grad(loss, list(st.disc.parameters()))
    pv.make_vocoder_train_step(P_GEN, P_DISC, pv.VocoderTrainingConfig(**_tc()), A)(st, batch)
    for p, w in zip(st.disc.parameters(), want):
        assert p.requires_grad
        torch.testing.assert_close(p.grad, w, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# the loader, checkpoints and the loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("vws")
    jcfg = make_training_workspace(root)
    path = root / "config.json"
    path.write_text(json.dumps(jcfg.model_checkpoint_dump()))
    return root, jcfg, FastSpeech2Config.from_file(path)


def test_crop_loader_matches_jax(workspace):
    _, jcfg, pcfg = workspace
    tc = dict(batch_size=3, frames_per_crop=8, seed=5)
    jl = jv.VocoderCropLoader(jcfg, jv.VocoderTrainingConfig(**tc))
    pl = pv.VocoderCropLoader(pcfg, pv.VocoderTrainingConfig(**tc))
    assert [tuple(map(str, p)) for p in pl.items] == [tuple(map(str, p)) for p in jl.items]
    for _ in range(4):
        jb, pb = jl.next_batch(), pl.next_batch()
        for k in ("mel", "wav"):
            assert pb[k].dtype == np.float32 and np.array_equal(pb[k], jb[k]), k
    # crops longer than the utterances: padded with log(LOG_CLIP) and zeros
    long = dict(tc, frames_per_crop=64)
    jb = jv.VocoderCropLoader(jcfg, jv.VocoderTrainingConfig(**long)).next_batch()
    pb = pv.VocoderCropLoader(pcfg, pv.VocoderTrainingConfig(**long)).next_batch()
    assert np.array_equal(pb["mel"], jb["mel"]) and np.array_equal(pb["wav"], jb["wav"])
    assert (pb["wav"][:, -256:] == 0).all() and np.isclose(pb["mel"][0, -1, 0], np.log(1e-5))


def test_crop_loader_finetune_mels_matches_jax(workspace, tmp_path):
    from fastspeech2_lightning_tpu_torch.text.lookups import load_filelist
    from fastspeech2_lightning_tpu_torch.utils import slugify, truncate_basename

    _, jcfg, pcfg = workspace
    rows = load_filelist(pcfg.training.training_filelist)
    out = tmp_path / "synth_out" / "synthesized_spec"
    out.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, r in enumerate(rows):
        # the spec writer's name (the slugified text), and for one row the basename
        name = truncate_basename(r["basename"]) if i == 0 else truncate_basename(
            slugify(r["characters"]))
        np.save(out / f"{name}--{r['speaker']}--{r['language']}--spec-pred-22050-mel-librosa.npy",
                rng.standard_normal((20, 40)).astype(np.float32))
    tc = dict(batch_size=2, frames_per_crop=8, seed=0)
    jl = jv.VocoderCropLoader(jcfg, jv.VocoderTrainingConfig(**tc),
                              finetune_mel_dir=tmp_path / "synth_out")
    pl = pv.VocoderCropLoader(pcfg, pv.VocoderTrainingConfig(**tc),
                              finetune_mel_dir=tmp_path / "synth_out")
    assert [str(p[1]) for p in pl.items] == [str(p[1]) for p in jl.items]
    assert all("synthesized_spec" in str(p[1]) for p in pl.items)
    for _ in range(3):
        jb, pb = jl.next_batch(), pl.next_batch()
        assert np.array_equal(pb["mel"], jb["mel"]) and np.array_equal(pb["wav"], jb["wav"])


def test_save_and_resume_continue_bit_for_bit(jax_runs, tmp_path):
    tc = pv.VocoderTrainingConfig(**_tc())
    step = pv.make_vocoder_train_step(P_GEN, P_DISC, tc, A)
    st = _port_state(jax_runs["state0"])
    for i in range(3):
        step(st, _to_torch(_batch(i)))
    path = pv.save_vocoder_checkpoint(tmp_path / "ckpt", st)
    assert path.name == "step=3" and not list((tmp_path / "ckpt").glob("*.tmp"))
    meta = json.loads((path / "meta.json").read_text())
    assert meta["global_step"] == 3 and meta["model_info"] == {"name": "HiFiGAN",
                                                               "version": "1.0"}
    assert meta["generator_config"] == json.loads(json.dumps(dataclasses.asdict(J_GEN)))
    uninterrupted = step(st, _to_torch(_batch(3)))

    fresh = pv.create_vocoder_state(P_GEN, P_DISC, tc, device="cpu")
    pv.load_vocoder_training_checkpoint(path, fresh)
    assert fresh.step == 3
    assert all(int(s["step"]) == 3 for s in fresh.opt_g.state.values())
    resumed = step(fresh, _to_torch(_batch(3)))
    for k in pv.LOSS_KEYS:
        assert torch.equal(resumed[k], uninterrupted[k]), k
    for mod_a, mod_b in ((fresh.gen, st.gen), (fresh.disc, st.disc)):
        for (k, p), q in zip(mod_a.named_parameters(), mod_b.parameters()):
            assert torch.equal(p, q), k


def test_checkpoints_keep_five_and_skip_incomplete(jax_runs, tmp_path):
    st = _port_state(jax_runs["state0"])
    ckpt = tmp_path / "ckpt"
    for s in range(1, 8):
        st.step = s
        pv.save_vocoder_checkpoint(ckpt, st)
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "step=3", "step=4", "step=5", "step=6", "step=7", "vocoder.npz"]
    (ckpt / "step=9.tmp").mkdir()
    (ckpt / "step=8").mkdir()  # no meta.json: a save killed part way
    assert latest_checkpoint(ckpt).name == "step=7"


def _train(pcfg, tmp_path, name="voc", **kw):
    kw.setdefault("max_steps", 2)
    return pv.train_vocoder(pcfg, train_config=pv.VocoderTrainingConfig(
        batch_size=2, frames_per_crop=8, ckpt_steps=100, seed=0, log_steps=1),
        gen_config=P_GEN, disc_config=P_DISC, log_dir=tmp_path / name, device="cpu", **kw)


def test_train_vocoder_resumes_and_skips_incomplete(workspace, tmp_path):
    _, _, pcfg = workspace
    ckpt = tmp_path / "voc" / "checkpoints"
    ckpt.mkdir(parents=True)
    (ckpt / "step=9.tmp").mkdir()
    (ckpt / "step=50").mkdir()  # no meta.json
    st = _train(pcfg, tmp_path)
    assert st.step == 2 and (ckpt / "step=2" / "meta.json").exists()
    rows = [json.loads(line) for line in (tmp_path / "voc" / "vocoder_log.jsonl").open()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in pv.LOSS_KEYS)
    st = _train(pcfg, tmp_path, max_steps=3)
    assert st.step == 3
    assert json.loads((ckpt / "step=3" / "meta.json").read_text())["global_step"] == 3


def test_train_vocoder_errors(workspace, tmp_path, monkeypatch):
    from fastspeech2_lightning_tpu.testing import get_stubbed_vocoder

    _, _, pcfg = workspace
    bad = dataclasses.replace(P_GEN, upsample_rates=(8, 8, 2), upsample_kernel_sizes=(16, 16, 4))
    with pytest.raises(ValueError, match="upsampling"):
        pv.train_vocoder(pcfg, gen_config=bad, max_steps=1, device="cpu",
                         log_dir=tmp_path / "a")
    for name in ("MASTER_ADDR", "WORLD_SIZE", "FS2T_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2 .* --data-parallel 2"):
        _train(pcfg, tmp_path, name="b", data_parallel=2)
    _train(pcfg, tmp_path, name="c", max_steps=1)
    _, voc = get_stubbed_vocoder(tmp_path)
    with pytest.raises(ValueError, match="finetune-from given but"):
        pv.train_vocoder(pcfg, train_config=pv.VocoderTrainingConfig(
            batch_size=2, frames_per_crop=8), disc_config=P_DISC, max_steps=2,
            finetune_from=voc, log_dir=tmp_path / "c", device="cpu")
    with pytest.raises(ValueError, match="architecture differs"):
        _train(pcfg, tmp_path, name="d", finetune_from=voc)


def test_a_failing_loader_raises_in_the_loop(workspace, tmp_path, monkeypatch):
    """An error on the crop thread reaches the caller (no wait on an empty queue)."""
    _, _, pcfg = workspace

    def broken(self):
        raise OSError("the corpus went away")

    monkeypatch.setattr(pv.VocoderCropLoader, "next_batch", broken)
    with pytest.raises(OSError, match="corpus went away"):
        _train(pcfg, tmp_path, name="broken")


def test_finetune_from_starts_from_the_vocoder(workspace, tmp_path):
    from fastspeech2_lightning_tpu.testing import get_stubbed_vocoder

    _, _, pcfg = workspace
    _, voc = get_stubbed_vocoder(tmp_path)
    st = pv.train_vocoder(pcfg, train_config=pv.VocoderTrainingConfig(
        batch_size=2, frames_per_crop=8, learning_rate=0.0), disc_config=P_DISC,
        max_steps=1, resume=False, finetune_from=voc, log_dir=tmp_path / "ft", device="cpu")
    want, _, _ = ph.load_vocoder_params(voc)
    got = st.gen.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-7)


def test_jax_orbax_checkpoint_is_refused_by_name(workspace, tmp_path):
    _, _, pcfg = workspace
    jstate, _, _ = jv.create_vocoder_state(J_GEN, J_DISC, jv.VocoderTrainingConfig(**_tc()))
    ckpt = tmp_path / "voc" / "checkpoints"
    jv.save_vocoder_checkpoint(ckpt, jstate, J_GEN)
    with pytest.raises(ValueError, match=r"step=0.*orbax"):
        _train(pcfg, tmp_path)


def test_sigterm_checkpoints_and_exits_cleanly(workspace, tmp_path):
    _, _, pcfg = workspace
    root = workspace[0]
    log_dir = tmp_path / "sig"
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config\n"
        "from fastspeech2_lightning_tpu_torch.models.hifigan import HiFiGANConfig\n"
        "from fastspeech2_lightning_tpu_torch.models.hifigan_discriminators import "
        "DiscriminatorConfig\n"
        "from fastspeech2_lightning_tpu_torch.training import vocoder as pv\n"
        "import torch; torch.set_num_threads(2)\n"
        "pv.train_vocoder(FastSpeech2Config.from_file(%r), pv.VocoderTrainingConfig("
        "batch_size=2, frames_per_crop=8, ckpt_steps=1000, log_steps=1), HiFiGANConfig(**%r), "
        "DiscriminatorConfig(**%r), log_dir=%r, max_steps=10000, device='cpu')\n"
    ) % (str(REPO), str(root / "config.json"), GEN, DISC, str(log_dir))
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        log = log_dir / "vocoder_log.jsonl"
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            if log.exists() and len(log.read_text().splitlines()) >= 2:
                break
            time.sleep(0.05)
        assert proc.poll() is None, proc.stdout.read()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "received signal" in out
    last = [json.loads(line) for line in log.open()][-1]["step"]
    newest = latest_checkpoint(log_dir / "checkpoints")
    assert newest.name == f"step={last}"
    assert json.loads((newest / "meta.json").read_text())["global_step"] == last


def test_vocoder_npz_crosses_both_ways(jax_runs, tmp_path):
    """The port's vocoder.npz vocodes in JAX, and JAX's in the port, within 1e-5."""
    mel = _batch(1)["mel"]
    st = _port_state(jax_runs["state0"])
    pv.make_vocoder_train_step(P_GEN, P_DISC, pv.VocoderTrainingConfig(**_tc()), A)(
        st, _to_torch(_batch(0)))
    pv.save_vocoder_checkpoint(tmp_path / "port", st)
    port_npz = tmp_path / "port" / "vocoder.npz"
    loaded = np.load(port_npz, allow_pickle=True)
    leaves = jax.tree_util.tree_leaves(loaded["params"].item())
    assert leaves and all(type(x) is np.ndarray and x.dtype == np.float32 for x in leaves)
    jfn, jstep, jhop = jh.load_vocoder_checkpoint(port_npz)
    pfn, pstep, phop = ph.load_vocoder_checkpoint(port_npz, device="cpu")
    assert (jstep, jhop) == (pstep, phop) == (1, 256)
    jw, pw = np.asarray(jfn(mel)[0]), pfn(mel)[0]
    with torch.no_grad():
        direct = st.gen(torch.from_numpy(mel)).numpy()
    assert np.abs(pw - jw).max() <= 1e-5 and np.abs(pw - direct).max() <= 1e-6

    jstate = jax.tree_util.tree_map(jnp.asarray, jax_runs["states"][2])
    jstate["step"] = jnp.asarray(3, jnp.int32)
    jv.save_vocoder_checkpoint(tmp_path / "jax", jstate, J_GEN)
    jax_npz = tmp_path / "jax" / "vocoder.npz"
    jfn, _, _ = jh.load_vocoder_checkpoint(jax_npz)
    pfn, pstep, _ = ph.load_vocoder_checkpoint(jax_npz, device="cpu")
    assert pstep == 3
    assert np.abs(pfn(mel)[0] - np.asarray(jfn(mel)[0])).max() <= 1e-5


# ---------------------------------------------------------------------------
# data parallel: two gloo ranks on the CPU
# ---------------------------------------------------------------------------

DP_TIMEOUT_S = 150.0
AUDIO = types.SimpleNamespace(**{k: getattr(A, k) for k in vars(_Audio) if not k.startswith("_")})


@pytest.fixture(scope="module")
def dp_runs(jax_runs):
    """Two ranks from the JAX weights on batches 0, 1, 2 (one row each),
    with and without the generator's gradient average."""
    gen_sd = hifigan_state_from_jax(jax_runs["state0"]["gen"], P_GEN)
    disc_sd = discriminators_from_jax(jax_runs["state0"]["disc"])
    tc = pv.VocoderTrainingConfig(**_tc())
    ranks = run_local(torch_dp_workers.vocoder_steps, 2, P_GEN, P_DISC, tc, AUDIO, gen_sd,
                      disc_sd, [_batch(i) for i in range(3)], ("", "skip_g_average"),
                      timeout_s=DP_TIMEOUT_S)
    return {fault: [r[fault] for r in ranks] for fault in ranks[0]}


def _step1_problems(ranks, port_runs, state0) -> list:
    """What of the ranks' first step differs from the one-process step
    beyond summation order: a gradient (the ranks' average) past rel-L2
    1e-4, more than 1 % of the elements whose gradients differ beyond 1e-3
    relative (left out of the update check: zero to rounding, where Adam
    steps at the full rate either way), an update past rel-L2 1e-3 on the
    others, or a weight on which the ranks disagree."""
    problems, left, total = [], 0, 0
    for side, sd0 in (("gen", hifigan_state_from_jax(state0["gen"], P_GEN)),
                      ("disc", discriminators_from_jax(state0["disc"]))):
        got_g = ranks[0]["grads"][side]
        want_g = {k: v.numpy() for k, v in port_runs["grads"][side].items()}
        problems += [f"{side}.{k} gradient" for k in want_g if _rel(got_g[k], want_g[k]) > 1e-4]
        keep = settled([(got_g, want_g)])
        u_got = {k: ranks[0]["params"][side][k] - sd0[k] for k in sd0}
        u_want = {k: port_runs["params1"][side][k].numpy() - sd0[k] for k in sd0}
        for k, (rel, out, n) in update_errors(u_got, u_want, keep).items():
            left, total = left + out, total + n
            if rel > 1e-3:
                problems.append(f"{side}.{k} update")
        problems += [f"{side}.{k} ranks" for k, v in ranks[0]["params"][side].items()
                     if not np.array_equal(ranks[1]["params"][side][k], v)]
    if left > 0.01 * total:
        problems.append(f"{left} of {total} elements left out")
    return problems


def test_data_parallel_steps_match_one_process_and_jax(jax_runs, port_runs, dp_runs):
    ranks = dp_runs[""]
    for r in ranks[1:]:  # every rank logs the same mean
        assert r["losses"] == ranks[0]["losses"]
    for i in range(3):
        for k in pv.LOSS_KEYS:
            got = ranks[0]["losses"][i][k]
            for want in (port_runs["losses"][i][k], jax_runs["losses"][i][k]):
                assert abs(got - want) <= 2e-4 * abs(want) + 2e-5, (i, k, got, want)
    assert _step1_problems(ranks, port_runs, jax_runs["state0"]) == []


def test_skipping_the_generator_average_is_refused(jax_runs, port_runs, dp_runs):
    problems = _step1_problems(dp_runs["skip_g_average"], port_runs, jax_runs["state0"])
    assert any(p.startswith("gen.") for p in problems), problems
    assert not any(p.startswith("disc.") for p in problems), problems


def test_train_vocoder_data_parallel_writes_once_and_resumes(workspace, tmp_path):
    """Two ranks of train_vocoder at a global B 2 log the one-process run's
    losses, rank 0 alone writes step=2/ and the log, and a rerun at world 2
    resumes from it to step 3, as one process does."""
    _, _, pcfg = workspace
    tc = pv.VocoderTrainingConfig(batch_size=2, frames_per_crop=8, ckpt_steps=100, seed=0,
                                  log_steps=1, compute_dtype="float32")
    got = run_local(torch_dp_workers.train_vocoder_rank, 2, pcfg, tc, P_GEN, P_DISC,
                    tmp_path / "dp", (2, 3), timeout_s=DP_TIMEOUT_S)
    assert [[run["step"] for run in rank] for rank in got] == [[2, 3], [2, 3]]
    for steps in (2, 3):
        pv.train_vocoder(pcfg, train_config=tc, gen_config=P_GEN, disc_config=P_DISC,
                         log_dir=tmp_path / "one", max_steps=steps, device="cpu")
    ckpt = tmp_path / "dp" / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["step=2", "step=3", "vocoder.npz"]
    assert json.loads((ckpt / "step=3" / "meta.json").read_text())["global_step"] == 3
    rows = [json.loads(line) for line in (tmp_path / "dp" / "vocoder_log.jsonl").open()]
    want = [json.loads(line) for line in (tmp_path / "one" / "vocoder_log.jsonl").open()]
    assert [r["step"] for r in rows] == [r["step"] for r in want] == [1, 2, 3]
    for r, w in zip(rows, want):
        for k in pv.LOSS_KEYS:
            assert abs(r[k] - w[k]) <= 2e-4 * abs(w[k]) + 2e-5, (r["step"], k, r[k], w[k])
    for k, v in got[0][-1]["gen"].items():
        np.testing.assert_array_equal(got[1][-1]["gen"][k], v)
