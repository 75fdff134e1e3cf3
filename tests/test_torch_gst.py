"""Global style tokens in the PyTorch port against the JAX package, on the CPU.

The style encoder's parts (``ReferenceEncoder``, ``StyleTokenLayer``,
``StyleEncoder``) from the JAX init, carried by ``convert.py``, on an even
and an odd mel length (flax SAME padding takes (0, 1) and (1, 1) there, and
the GRU reads the frequency-major flatten): outputs within 1e-5 of the JAX
output's largest magnitude on running statistics, within 5e-5 on batch
statistics (three positions in the last BatchNorm; held to a float64 run
as well, see the test), and the BatchNorm running statistics after one training update within 1e-6;
``condition_on_gst_tokens`` for the first and last token and its index
check. A tiny FastSpeech2 with speakers, languages and GST together: the
inference forward with and without a style reference, the train step's
first gradients, three train steps' losses and weights, a JAX state after
two steps resumed in the port (``train_state_from_jax``), and the eval step,
against JAX as ``test_torch_train_step.py`` holds them (losses 1e-5
relative; gradients 1e-5 of each tensor's largest, 5e-5 in the reference
encoder; weights 1e-4, and 6e-3 where Adam scales float noise up to the
learning rate). The style
reference's log-mel and ``load_wav`` equal to the JAX functions'; the port's
``Synthesizer`` with a reference wav and without one against JAX's
(durations equal, mels within 1e-4); ``prepare_data(style_reference=)``
and the CLI's ``-S``; and a ``step=N/`` checkpoint that saves and resumes
the style encoder's statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.io import wavfile

from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
from fastspeech2_lightning_tpu.models.gst import StyleEncoder as JStyleEncoder
from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.preprocessing.features import (
    mel_spectrogram_numpy as j_mel_spectrogram_numpy,
)
from fastspeech2_lightning_tpu.preprocessing.pipeline import load_wav as j_load_wav
from fastspeech2_lightning_tpu.synthesis.api import Synthesizer as JSynthesizer
from fastspeech2_lightning_tpu.synthesis.prepare import prepare_data as j_prepare_data
from fastspeech2_lightning_tpu.testing import get_stubbed_model, stub_config
from fastspeech2_lightning_tpu.training.loss import compute_loss as j_compute_loss
from fastspeech2_lightning_tpu.training.state import create_train_state
from fastspeech2_lightning_tpu.training.step import make_eval_step, make_train_step
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.checkpoint import load_model_from_checkpoint
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import _gst, state_dict_from_jax, train_state_from_jax
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.models.gst import StyleEncoder, same_padding
from fastspeech2_lightning_tpu_torch.preprocessing.features import mel_spectrogram_numpy
from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import load_wav
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.synthesis.prepare import prepare_data
from fastspeech2_lightning_tpu_torch.text import TextProcessor
from fastspeech2_lightning_tpu_torch.training.checkpoint import save_checkpoint, take_snapshot
from fastspeech2_lightning_tpu_torch.training.loss import compute_loss
from fastspeech2_lightning_tpu_torch.training.state import AdamWNoam, init_like_flax
from fastspeech2_lightning_tpu_torch.training.step import (
    batch_to_device,
    eval_step,
    step_generator,
    train_step,
)

from helpers import synthetic_batch, tiny_config, tiny_stats

torch.set_num_threads(2)
N_MELS, D = 20, 32
N_SYMBOLS = 30
EPOCH = 50
LR = 1e-3
REL = 1e-5  # of the JAX value's largest magnitude
REL_BATCH_STATS = 5e-5  # the style encoder on batch statistics (see its test)
ATOL = 1e-4  # weights after three Adam steps, as test_torch_train_step.py
# entries whose gradient is zero in exact arithmetic (test_torch_train_step.py):
# Adam turns their float noise into steps of up to the learning rate
NOISE_ATOL = 6 * LR
SPEC_ATOL = 1e-4
# biases whose gradient is zero in exact arithmetic: the key third of the
# attention's in_proj_bias, the depthwise conv bias before a BatchNorm on batch
# statistics, and the style attention's key bias (softmax over keys ignores it)
ZERO_GRADIENT = ("in_proj_bias", ".conv_module.sequential.2.bias", "stl.mha.linear_k.bias")
TEXTS = ["hello world, how are you today", "the quick brown fox"]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the style encoder alone ---------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    jmodel = JStyleEncoder(idim=N_MELS, gst_token_dim=D)
    mel = np.random.default_rng(0).standard_normal((3, 40, N_MELS)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), mel)
    # running statistics away from their (0, 1) start, so both modes differ
    rng = np.random.default_rng(1)
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.abs(rng.standard_normal(v.shape)).astype(np.float32) + 0.5),
        variables["batch_stats"])}
    sd = {}
    _gst(sd, "gst", _np(variables["params"]), _np(variables["batch_stats"]))
    return jmodel, variables, {k[len("gst."):]: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}


def _port_encoder(state):
    model = StyleEncoder(idim=N_MELS, gst_token_dim=D)
    model.load_state_dict(state, strict=True)
    return model


def _mel(T, seed=2):
    return np.random.default_rng(seed).standard_normal((3, T, N_MELS)).astype(np.float32)


PARTS = {
    "reference_encoder": (lambda m, x, d: m.ref_enc(x, deterministic=d),
                          lambda m, x, r: m.ref_enc(x, r)),
    "style_encoder": (lambda m, x, d: m(x, deterministic=d), lambda m, x, r: m(x, r)),
}


def _reference_encoder_f64(state, mel):
    """The reference encoder on batch statistics in float64 (functional)."""
    x = torch.from_numpy(mel).double()[:, None]
    for i in range(6):
        pad_t, pad_f = same_padding(x.shape[2], 3, 2), same_padding(x.shape[3], 3, 2)
        x = F.conv2d(F.pad(x, pad_f + pad_t), state[f"ref_enc.convs.{3 * i}.weight"].double(),
                     stride=2)
        mean = x.mean((0, 2, 3), keepdim=True)
        var = (x * x).mean((0, 2, 3), keepdim=True) - mean * mean
        w, b = (state[f"ref_enc.convs.{3 * i + 1}.{k}"].double()[None, :, None, None]
                for k in ("weight", "bias"))
        x = torch.relu((x - mean) / torch.sqrt(var + 1e-5) * w + b)
    B, C, T, Fq = x.shape
    gru = torch.nn.GRU(Fq * C, 128, batch_first=True).double()
    gru.load_state_dict({k[len("ref_enc.gru."):]: v.double() for k, v in state.items()
                         if k.startswith("ref_enc.gru.")})
    with torch.no_grad():
        return gru(x.permute(0, 2, 3, 1).reshape(B, T, Fq * C))[0][:, -1].numpy()


@pytest.mark.parametrize("running", [True, False], ids=["running_stats", "batch_stats"])
@pytest.mark.parametrize("T", [40, 37], ids=["even_T", "odd_T"])
@pytest.mark.parametrize("part", list(PARTS))
def test_style_encoder_parts_match_jax(encoders, part, T, running):
    """On batch statistics the last BatchNorm normalizes over B * 1 * 1 = 3
    positions, so both frameworks' f32 roundings are amplified: at T = 37
    each lies about 1.8e-5 from float64 and they 3.6e-5 from each other.
    There the port is held to 5e-5 of JAX and to no farther from float64
    than 1.5 times JAX's distance."""
    jmodel, variables, state = encoders
    jfn, pfn = PARTS[part]
    mel = _mel(T)
    want = jmodel.apply(variables, mel, running, method=jfn,
                        mutable=False if running else ["batch_stats"])
    want = np.asarray(want if running else want[0])
    got = pfn(_port_encoder(state), torch.from_numpy(mel), running).detach().numpy()
    assert got.shape == want.shape
    if running:
        assert _rel(got, want) <= REL
        return
    assert _rel(got, want) <= REL_BATCH_STATS
    if part == "reference_encoder":
        exact = _reference_encoder_f64(state, mel)
        assert _rel(got, exact) <= 1.5 * max(_rel(want, exact), REL / 10)


def test_style_token_layer_matches_jax(encoders):
    jmodel, variables, state = encoders
    ref = np.random.default_rng(8).standard_normal((3, 128)).astype(np.float32)
    want = jmodel.apply(variables, ref, method=lambda m, x: m.stl(x))
    got = _port_encoder(state).stl(torch.from_numpy(ref))
    assert got.shape == (3, D)
    assert _rel(got.detach().numpy(), want) <= REL


@pytest.mark.parametrize("T", [40, 37], ids=["even_T", "odd_T"])
def test_batch_statistics_after_one_update_match_jax(encoders, T):
    jmodel, variables, state = encoders
    mel = _mel(T, seed=3)
    _, updated = jmodel.apply(variables, mel, deterministic=False, mutable=["batch_stats"])
    port = _port_encoder(state)
    port(torch.from_numpy(mel), use_running_average=False)
    bs = _np(updated["batch_stats"])["ref_enc"]
    for i in range(6):
        bn = port.ref_enc.convs[3 * i + 1]
        for ours, theirs in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(ours.numpy(), bs[f"bn_{i}"][theirs], rtol=0, atol=1e-6)
    assert not np.allclose(port.ref_enc.convs[16].running_var.numpy(),
                           state["ref_enc.convs.16.running_var"].numpy())


@pytest.mark.parametrize("index", [0, 9])
def test_condition_on_gst_tokens_matches_jax(encoders, index):
    jmodel, variables, state = encoders
    want = jmodel.apply(variables, 4, index, method=JStyleEncoder.condition_on_gst_tokens)
    got = _port_encoder(state).condition_on_gst_tokens(4, index)
    assert got.shape == (4, D)
    assert _rel(got.detach().numpy(), want) <= REL


def test_condition_on_gst_tokens_checks_the_index(encoders):
    jmodel, variables, state = encoders
    with pytest.raises(ValueError, match="one of 10 GST tokens") as jerr:
        jmodel.apply(variables, 2, 10, method=JStyleEncoder.condition_on_gst_tokens)
    with pytest.raises(ValueError) as perr:
        _port_encoder(state).condition_on_gst_tokens(2, 10)
    assert str(perr.value) == str(jerr.value)


# -- a conditioned FastSpeech2: forward, train step, eval step -------------------


def _conditioned_config():
    cfg = tiny_config(dtype="float32", use_postnet=False, multispeaker=True, multilingual=True,
                      use_global_style_token_module=True)
    for conf in (cfg.model.encoder, cfg.model.decoder):
        conf.dropout = 0.0
    vp = cfg.model.variance_predictors
    for conf in (vp.pitch, vp.energy, vp.duration):
        conf.dropout = 0.0
    cfg.training.optimizer.warmup_steps = 1
    cfg.training.optimizer.learning_rate = LR
    return cfg


def _batch(seed=0):
    batch = synthetic_batch(np.random.default_rng(seed), B=3, L=12, T=48)
    batch["speaker_id"] = np.array([0, 1, 1], np.int32)
    batch["language_id"] = np.array([1, 0, 1], np.int32)
    batch["sample_weight"] = np.array([1.0, 1.0, 0.0], np.float32)
    return batch


def _state_dict(params, batch_stats, constants, cfg, stats):
    sd = state_dict_from_jax(_np(params), _np(batch_stats), _np(constants), cfg, stats)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_run():
    cfg, stats = _conditioned_config(), tiny_stats()
    model = JFastSpeech2(config=cfg, stats=stats, n_symbols=N_SYMBOLS, n_speakers=2,
                         n_languages=2)
    batch = _batch()
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch)
    vp = cfg.model.variance_predictors
    state = state.replace(constants={"variance_adaptor": {
        "pitch_bins": jnp.linspace(stats.pitch.norm_min, stats.pitch.norm_max,
                                   vp.pitch.n_bins - 1),
        "energy_bins": jnp.linspace(stats.energy.norm_min, stats.energy.norm_max,
                                    vp.energy.n_bins - 1),
    }})
    assert "gst" in state.params and "gst" in state.batch_stats
    start = _state_dict(state.params, state.batch_stats, state.constants, cfg, stats)
    variables = {"params": state.params, "batch_stats": state.batch_stats,
                 "constants": state.constants}
    ref = np.random.default_rng(5).standard_normal((3, 45, N_MELS)).astype(np.float32)
    infer = {}
    predict = jax.jit(lambda v, b: model.apply(v, b, inference=True, deterministic=True,
                                               max_target_len=64))
    for name, extra in (("token_0", {}), ("reference", {"mel_style_reference": ref})):
        ib = dict(synthetic_batch(np.random.default_rng(6), B=3, L=12, inference=True), **extra)
        ib["speaker_id"], ib["language_id"] = _batch()["speaker_id"], _batch()["language_id"]
        out = predict(variables, {k: v for k, v in ib.items() if v is not None})
        infer[name] = (ib, {k: np.asarray(out[k]) for k in ("output", "duration_rounded")})

    def loss_fn(params):
        out, _ = model.apply(dict(variables, params=params), batch, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(9)}, mutable=["batch_stats"])
        return j_compute_loss(cfg, out, batch, EPOCH)["total"]

    grads = state_dict_from_jax(_np(jax.jit(jax.grad(loss_fn))(state.params)), None, None, cfg)
    jlosses, _ = make_eval_step(cfg, model)(state, batch, EPOCH)
    step = make_train_step(cfg, model)
    losses = []
    for k in range(3):
        state, lk = step(state, batch, jax.random.PRNGKey(1), EPOCH)
        losses.append({name: float(v) for name, v in lk.items()})
        if k == 1:  # copies: the next step donates the state's buffers
            after_two = jax.tree_util.tree_map(np.array, dict(
                params=state.params, opt_state=state.opt_state, batch_stats=state.batch_stats,
                constants=state.constants))
    return dict(cfg=cfg, stats=stats, start=start, infer=infer, grads=grads, losses=losses,
                eval_losses={k: float(v) for k, v in jlosses.items()}, after_two=after_two,
                end=_state_dict(state.params, state.batch_stats, state.constants, cfg, stats))


def _port_model(jax_run):
    cfg = FastSpeech2Config.from_dict(jax_run["cfg"].model_checkpoint_dump())
    model = FastSpeech2(cfg, n_symbols=N_SYMBOLS, n_speakers=2, n_languages=2)
    model.load_state_dict(jax_run["start"], strict=True)
    return cfg, model


@pytest.mark.parametrize("style", ["token_0", "reference"])
def test_conditioned_forward_matches_jax(jax_run, style):
    _, model = _port_model(jax_run)
    ib, want = jax_run["infer"][style]
    t = {k: torch.from_numpy(np.asarray(v)).long() if k != "mel_style_reference"
         else torch.from_numpy(v) for k, v in ib.items() if v is not None}
    out = model.eval()(t["text"], t["src_lens"], 64, speaker_id=t["speaker_id"],
                       language_id=t["language_id"], mel_style_reference=t.get(
                           "mel_style_reference"))
    np.testing.assert_array_equal(out["duration_rounded"].numpy(), want["duration_rounded"])
    assert _rel(out["output"].numpy(), want["output"]) <= REL


def test_first_gradients_match_jax(jax_run):
    cfg, model = _port_model(jax_run)
    db = batch_to_device(_batch(), "cpu")
    losses = compute_loss(cfg, model.forward_train(db, step_generator(0, 0, "cpu")), db, EPOCH)
    losses["total"].backward()
    grads = dict(model.named_parameters())
    assert {n for n in grads if n.startswith("gst.")} == {
        n for n in jax_run["grads"] if n.startswith("gst.") and "running" not in n
        and not n.endswith("num_batches_tracked")}
    for name, p in grads.items():
        want = jax_run["grads"][name]
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        if name.endswith(ZERO_GRADIENT):
            continue  # zero in exact arithmetic (the float noise differs)
        # the style encoder's BatchNorms on batch statistics: see
        # test_style_encoder_parts_match_jax
        rel = REL_BATCH_STATS if name.startswith("gst.ref_enc.") else REL
        assert float(np.abs(got - want).max()) <= rel * scale, name
    n = 2 * 128
    np.testing.assert_array_equal(grads["gst.ref_enc.gru.bias_hh_l0"].grad[:n].numpy(), 0.0)
    assert float(grads["gst.ref_enc.gru.weight_ih_l0"].grad.abs().max()) > 0


def test_three_conditioned_train_steps_match_jax(jax_run):
    cfg, model = _port_model(jax_run)
    db = batch_to_device(_batch(), "cpu")
    params = dict(model.named_parameters())
    opt = AdamWNoam(list(params.items()), cfg.training)
    for k, want in enumerate(jax_run["losses"]):
        got = train_step(model, opt, cfg, db, k, EPOCH)
        _assert_losses_close(got, want)
    _assert_state_close(model, params, jax_run)
    moved = jax_run["start"]["gst.ref_enc.convs.1.running_mean"]
    assert not torch.allclose(model.state_dict()["gst.ref_enc.convs.1.running_mean"], moved)


def test_a_jax_gst_state_resumed_in_the_port_takes_jax_third_step(jax_run):
    """``train_state_from_jax`` carries the style encoder's parameters,
    Adam moments (the GRU's folded r and z biases among them) and BatchNorm
    statistics."""
    j = jax_run["after_two"]
    adam = _adam_state(j["opt_state"])
    sd, ts = train_state_from_jax(j["params"], adam.mu, adam.nu, adam.count, None,
                                  j["batch_stats"], j["constants"], jax_run["cfg"],
                                  jax_run["stats"])
    assert ts["count"] == 2 and "gst.stl.gst_embs" in ts["mu"]
    np.testing.assert_array_equal(ts["mu"]["gst.ref_enc.gru.bias_hh_l0"][:256], 0.0)
    cfg = FastSpeech2Config.from_dict(jax_run["cfg"].model_checkpoint_dump())
    model = FastSpeech2(cfg, n_symbols=N_SYMBOLS, n_speakers=2, n_languages=2)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    params = dict(model.named_parameters())
    opt = AdamWNoam(list(params.items()), cfg.training)
    opt.load_state(ts["mu"], ts["nu"], ts["count"])
    got = train_step(model, opt, cfg, batch_to_device(_batch(), "cpu"), 2, EPOCH)
    _assert_losses_close(got, jax_run["losses"][2])
    _assert_state_close(model, params, jax_run)


def _adam_state(opt_state):
    """The optax ScaleByAdamState inside a chain's nested state tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for sub in opt_state if isinstance(opt_state, (tuple, list)) else ():
        found = _adam_state(sub)
        if found is not None:
            return found
    return None


def _assert_losses_close(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        assert abs(float(got[name]) - value) <= REL * max(abs(value), 1.0), name


def _assert_state_close(model, params, jax_run):
    """The port's weights and statistics against JAX's after its third
    step: 1e-4, and 6e-3 where Adam scales float noise up to the learning
    rate (see NOISE_ATOL)."""
    for name, value in model.state_dict().items():
        want = jax_run["end"][name]
        err = (value.float() - want.float()).abs()
        if name.endswith("in_proj_bias"):
            d = err.shape[0] // 3
            assert float(err[d: 2 * d].max()) <= NOISE_ATOL, name
            err = torch.cat([err[:d], err[2 * d:]])
        noisy = (".conv_module.sequential.2.bias", ".conv_module.sequential.3.running_mean",
                 "stl.mha.linear_k.bias")
        if name.startswith("gst.ref_enc.") and name in params:
            # Adam moves an entry by up to the learning rate whatever its
            # gradient's size, so entries whose first gradient is under
            # 1e-3 of the tensor's largest (within the float noise of the
            # batch statistics) are held as the noisy ones
            g = np.abs(jax_run["grads"][name])
            small = torch.from_numpy(g <= 1e-3 * g.max())
            if small.any():
                assert float(err[small].max()) <= NOISE_ATOL, name
            err = err[~small]
        limit = NOISE_ATOL if name.endswith(noisy) else ATOL
        assert err.numel() == 0 or float(err.max()) <= limit, name


def test_conditioned_eval_step_matches_jax(jax_run):
    cfg, model = _port_model(jax_run)
    losses, _ = eval_step(model, cfg, batch_to_device(_batch(), "cpu"), EPOCH)
    want = jax_run["eval_losses"]
    assert set(want) <= set(losses)
    for name, value in want.items():
        assert abs(float(losses[name]) - value) <= REL * max(abs(value), 1.0), name


# -- style references: wav to log-mel, Synthesizer, prepare_data, CLI -------------


def _write_wav(path, sr, kind, seed):
    rng = np.random.default_rng(seed)
    n = int(sr * 0.6)
    t = np.arange(n) / sr
    x = 0.4 * np.sin(2 * np.pi * (180 + 60 * seed) * t) + 0.05 * rng.standard_normal(n)
    if kind == "int16":
        data = (x * 32000).astype(np.int16)
    elif kind == "int32":
        data = (x * 2.0e9).astype(np.int32)
    else:
        data = np.stack([x, 0.5 * x], axis=1).astype(np.float32)
    wavfile.write(path, sr, data)
    return path


WAVS = {"int16_16k": (16000, "int16"), "int32_44k": (44100, "int32"),
        "float32_stereo_22k": (22050, "float32")}


@pytest.mark.parametrize("name", list(WAVS))
def test_load_wav_matches_jax(tmp_path, name):
    sr, kind = WAVS[name]
    path = _write_wav(tmp_path / f"{name}.wav", sr, kind, seed=1)
    np.testing.assert_array_equal(load_wav(path, 22050), j_load_wav(path, 22050))


@pytest.mark.parametrize("spec_type", ["mel-librosa", "mel", "linear"])
def test_mel_spectrogram_numpy_matches_jax(spec_type):
    audio = np.random.default_rng(4).standard_normal(5000).astype(np.float32) * 0.3
    args = (audio, 22050, 1024, 256, 1024, 80, 0, 8000, spec_type)
    np.testing.assert_array_equal(mel_spectrogram_numpy(*args), j_mel_spectrogram_numpy(*args))


@pytest.fixture(scope="module")
def gst_stub(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gst_stub")
    config = stub_config(dtype="float32", use_global_style_token_module=True)
    _, orbax_dir = get_stubbed_model(tmp / "model", config=config)
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp / "model.ckpt")
    refs = [_write_wav(tmp / f"ref{i}.wav", 16000, "int16", seed=i) for i in (1, 2)]
    jax_syn = JSynthesizer.from_checkpoint(orbax_dir)
    port_syn = Synthesizer.from_checkpoint(ckpt, device="cpu")
    return dict(tmp=tmp, ckpt=ckpt, refs=refs, jax=jax_syn, port=port_syn)


@pytest.mark.parametrize("with_reference", [True, False], ids=["reference_wav", "token_0"])
def test_synthesizer_style_matches_jax(gst_stub, with_reference):
    kwargs = {"style_reference": gst_stub["refs"][0]} if with_reference else {}
    want = gst_stub["jax"].synthesize(TEXTS, **kwargs)
    got = gst_stub["port"].synthesize(TEXTS, **kwargs)
    for j, p in zip(want.durations, got.durations):
        np.testing.assert_array_equal(p, j)
    for j, p in zip(want.mels, got.mels):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, rtol=0, atol=SPEC_ATOL)


def test_two_references_give_two_styles(gst_stub):
    syn = gst_stub["port"]
    embs = []
    for ref in gst_stub["refs"]:
        mel = torch.from_numpy(syn._style_reference_mel(ref))[None]
        with torch.no_grad():
            embs.append(syn.model.gst(mel).numpy())
    assert np.abs(embs[0] - embs[1]).max() > 1e-4
    assert set(syn._style_cache) == {str(r) for r in gst_stub["refs"]}


def test_a_model_without_gst_refuses_a_reference(gst_stub, tmp_path):
    _, orbax_dir = get_stubbed_model(tmp_path / "plain", config=stub_config(dtype="float32"))
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp_path / "plain.ckpt")
    with pytest.raises(ValueError) as jerr:
        JSynthesizer.from_checkpoint(orbax_dir).synthesize(["abc"], style_reference=gst_stub[
            "refs"][0])
    with pytest.raises(ValueError) as perr:
        Synthesizer.from_checkpoint(ckpt, device="cpu").synthesize(
            ["abc"], style_reference=gst_stub["refs"][0])
    assert str(perr.value) == str(jerr.value)


def test_server_applies_its_style_reference(gst_stub):
    import io
    import json
    import urllib.request

    from fastspeech2_lightning_tpu_torch.serving.server import SynthesisServer

    ref = gst_stub["refs"][1]
    srv = SynthesisServer(gst_stub["port"], port=0, max_batch=2, style_reference=ref)
    srv.start()
    try:
        host, port = srv.address[:2]
        req = urllib.request.Request(f"http://{host}:{port}/synthesize",
                                     data=json.dumps({"text": TEXTS[1], "format": "mel"}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            mel = np.load(io.BytesIO(r.read()))
    finally:
        srv.shutdown()
    want = gst_stub["port"].synthesize([TEXTS[1]], style_reference=ref).mels[0]
    plain = gst_stub["port"].synthesize([TEXTS[1]]).mels[0]
    assert mel.shape == want.shape
    np.testing.assert_allclose(mel, want, rtol=0, atol=SPEC_ATOL)
    assert mel.shape != plain.shape or np.abs(mel - plain).max() > 1e-4


def test_prepare_data_carries_the_reference_mel(gst_stub):
    syn = gst_stub["port"]
    args = (["hello there"], None, None, None)
    want = j_prepare_data(*args, gst_stub["jax"].config, gst_stub["jax"].stats,
                          gst_stub["jax"].lang2id, gst_stub["jax"].speaker2id,
                          style_reference=gst_stub["refs"][1])
    got = prepare_data(*args, syn.config, syn.stats, syn.lang2id, syn.speaker2id,
                       style_reference=gst_stub["refs"][1])
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0]["mel_style_reference"], want[0]["mel_style_reference"])


def test_cli_style_reference_spec_equals_the_synthesizer(gst_stub, tmp_path):
    cli.main(["synthesize", str(gst_stub["ckpt"]), "-t", TEXTS[0], "-S",
              str(gst_stub["refs"][0]), "-O", "spec", "-o", str(tmp_path), "--device", "cpu"])
    specs = list(tmp_path.rglob("*spec-pred*.npy"))
    assert len(specs) == 1
    spec = np.load(specs[0])  # [n_mels, T]
    want = gst_stub["port"].synthesize([TEXTS[0]], style_reference=gst_stub["refs"][0]).mels[0]
    assert spec.shape == want.T.shape
    np.testing.assert_allclose(spec, want.T, rtol=0, atol=SPEC_ATOL)


def test_step_checkpoint_saves_and_resumes_gst_statistics(tmp_path):
    jcfg, jstats = _conditioned_config(), tiny_stats()
    cfg = FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())
    symbols = TextProcessor(cfg.text).symbols
    model = FastSpeech2(cfg, n_symbols=len(symbols), n_speakers=2, n_languages=2)
    init_like_flax(model, 0)
    start = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("gst.")}
    opt = AdamWNoam(list(model.named_parameters()), cfg.training)
    batch = _batch(7)
    batch["text"] = np.minimum(batch["text"], len(symbols) - 1)
    db = batch_to_device(batch, "cpu")
    for k in range(2):
        train_step(model, opt, cfg, db, k, EPOCH)
    snap = take_snapshot(model, opt, None, step=2, epoch=0)
    step_dir = save_checkpoint(tmp_path, snap, cfg.to_dict(), jstats.model_dump(mode="json"),
                               {"l0": 0, "l1": 1}, {"s0": 0, "s1": 1}, symbols)
    loaded, *_ = load_model_from_checkpoint(step_dir, device="cpu")
    saved = model.state_dict()
    for name, value in loaded.state_dict().items():
        if name.startswith("gst."):
            assert torch.equal(value, saved[name]), name
    assert not torch.equal(saved["gst.ref_enc.convs.4.running_var"],
                           start["gst.ref_enc.convs.4.running_var"])
    assert torch.equal(saved["gst.ref_enc.gru.bias_hh_l0"][:256],
                       start["gst.ref_enc.gru.bias_hh_l0"][:256])
    with torch.no_grad():
        a = loaded.gst(db["mel"])
        b = model.eval().gst(db["mel"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
