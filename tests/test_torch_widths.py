"""The widths the port's kernels take beyond the default model's, on the CPU.

- A narrow form of the d-384, 2-head configuration (ESPnet2's LJSpeech
  ``conformer_fastspeech2`` widths on this package's Conformer: conv kernels
  7 and 31, feed-forward 4 d): d 48, 2 heads (dh 24, which the attention
  kernels run padded to 64), 1 + 1 layers, in f32 through the weight bridge.
  Its inference forward, teacher-forced forward and one training step (no
  dropout, no PostNet) against the JAX model's: durations equal, every output, loss and
  parameter within max-abs 1e-4 (the two frameworks sum in different
  orders; the tolerance of ``test_torch_model.py`` and
  ``test_torch_train_step.py``, with the latter's allowance for the
  parameters whose gradient is zero to rounding).
- The attention wrappers' padding step (``padded_fwd``, ``padded_bwd``)
  composed with the plain versions, against the plain versions unpadded,
  forward and backward, p 0 and 0.2 with one seed, for dh from 16 to 256:
  rel-L2 at most 1e-6 in f32 (zero columns add exact zeros; only the order
  of a sum may differ); above 256 the width is the next multiple of 128
  (``test_torch_long_shapes.py`` holds the padding step there).
- The port's MRF routing gate equal to the JAX package's over C 1..256, odd
  k 3..13, dilation triples from {1, 2, 3, 5, 7, 9} and single dilations to
  63; a stage of C 8 to 96 at the width its route runs it at (C 8 at its
  own width on the whole-stage kernel, 24 at 32 and 96 at 128 with zero
  channels), against the unpadded plain stage on the same weights: rel-L2
  at most 1e-6 in f32.
- The port's HiFiGAN V2 generator (``upsample_initial_channel`` 128, jik876's
  ``config_v2.json``), fused, against the JAX package's ``make_vocoder_fn``
  on a short mel: its four stages C 64, 32, 16 and 8 all fused, within
  max-abs 1e-5 (the f32 stage multiplies split bf16 weight pairs, 2^-16
  apart from the f32 weights; ``test_torch_vocoder.py``'s tolerance).
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
from fastspeech2_lightning_tpu.models import hifigan as jax_hifigan
from fastspeech2_lightning_tpu.ops import vocoder_resblocks as jax_mrf
from fastspeech2_lightning_tpu.training.state import create_train_state
from fastspeech2_lightning_tpu.training.step import make_train_step
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import hifigan_state_from_jax, state_dict_from_jax
from fastspeech2_lightning_tpu_torch.models import hifigan as port_hifigan
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.ops import attention
from fastspeech2_lightning_tpu_torch.ops import vocoder_resblocks as port_mrf
from fastspeech2_lightning_tpu_torch.training.state import AdamWNoam
from fastspeech2_lightning_tpu_torch.training.step import batch_to_device, train_step

from helpers import synthetic_batch, tiny_config, tiny_stats

torch.set_num_threads(2)

N_SYMBOLS = 30
D, HEADS, FF = 48, 2, 192
T_MAX = 96
ATOL = 1e-4
LR = 1e-3
NOISE_ATOL = 2 * LR  # one step: see test_torch_train_step.py
EPOCH = 50
PAD_REL = 1e-6
CLOSE = ("duration_prediction", "pitch_prediction", "energy_prediction", "output")


def wide_head_config():
    """The d-384 configuration's shape at d 48: 2 heads, feed-forward 4 d,
    conv kernels 7 (encoder) and 31 (decoder), 1 + 1 layers, no dropout and
    no PostNet (its 0.5 dropout has no switch)."""
    cfg = tiny_config(dtype="float32", max_mel_length=T_MAX, use_postnet=False)
    for conf, kernel in ((cfg.model.encoder, 7), (cfg.model.decoder, 31)):
        conf.input_dim, conf.heads, conf.feedforward_dim = D, HEADS, FF
        conf.conv_kernel_size, conf.dropout = kernel, 0.0
    vp = cfg.model.variance_predictors
    for conf in (vp.pitch, vp.energy, vp.duration):
        conf.input_dim, conf.dropout = D, 0.0
    cfg.training.ema_decay = 0.9
    cfg.training.optimizer.warmup_steps = 1
    cfg.training.optimizer.learning_rate = LR
    return cfg


def _batch(seed=0):
    batch = synthetic_batch(np.random.default_rng(seed), B=3, L=12, T=48)
    batch["sample_weight"] = np.array([1.0, 1.0, 0.0], np.float32)
    return batch


def _port_state_dict(state, cfg, stats):
    tree = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats, state.constants))
    return {k: torch.from_numpy(np.array(v))
            for k, v in state_dict_from_jax(*tree, cfg, stats).items()}


@pytest.fixture(scope="module")
def wide():
    """The JAX model, its initial state carried to the port, and the JAX
    outputs: inference, teacher-forced (both deterministic) and one
    training step's losses and state."""
    cfg, stats = wide_head_config(), tiny_stats()
    assert cfg.model.encoder.input_dim // cfg.model.encoder.heads == 24
    model = JFastSpeech2(config=cfg, stats=stats, n_symbols=N_SYMBOLS)
    batch = _batch()
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch)
    vp = cfg.model.variance_predictors
    state = state.replace(constants={"variance_adaptor": {
        "pitch_bins": jnp.linspace(stats.pitch.norm_min, stats.pitch.norm_max,
                                   vp.pitch.n_bins - 1),
        "energy_bins": jnp.linspace(stats.energy.norm_min, stats.energy.norm_max,
                                    vp.energy.n_bins - 1),
    }})
    start = _port_state_dict(state, cfg, stats)
    variables = {"params": state.params, "batch_stats": state.batch_stats,
                 "constants": state.constants}
    inference_batch = {k: batch[k] for k in ("text", "src_lens", "speaker_id", "language_id")}
    inference_batch.update(mel=None, mel_lens=None)
    inference = jax.jit(lambda v, b: model.apply(v, b, inference=True, deterministic=True,
                                                 max_target_len=T_MAX))(variables,
                                                                        inference_batch)
    teacher = jax.jit(lambda v, b: model.apply(v, b, inference=True, teacher_forcing=True,
                                               deterministic=True))(variables, batch)
    state, losses = make_train_step(cfg, model)(state, batch, jax.random.PRNGKey(1), EPOCH)

    def numpy_outputs(out):
        return {k: np.asarray(v) for k, v in out.items() if v is not None}

    return dict(cfg=cfg, batch=batch, start=start, inference=numpy_outputs(inference),
                teacher=numpy_outputs(teacher), losses={k: float(v) for k, v in losses.items()},
                end=_port_state_dict(state, cfg, stats))


def _port_model(wide):
    cfg = FastSpeech2Config.from_dict(wide["cfg"].model_checkpoint_dump())
    model = FastSpeech2(cfg, n_symbols=N_SYMBOLS)
    model.load_state_dict(wide["start"], strict=True)
    return cfg, model


def _assert_outputs(got, want):
    np.testing.assert_array_equal(got["duration_rounded"].numpy(), want["duration_rounded"])
    for key in CLOSE:
        np.testing.assert_allclose(got[key].float().numpy(), want[key], rtol=0, atol=ATOL,
                                   err_msg=key)


def test_inference_forward_matches_jax(wide):
    _, model = _port_model(wide)
    b = wide["batch"]
    with torch.inference_mode():
        got = model.eval()(torch.as_tensor(b["text"], dtype=torch.int64),
                           torch.as_tensor(b["src_lens"]), T_MAX)
    want = wide["inference"]
    assert (want["duration_rounded"] > 0).any()
    np.testing.assert_array_equal(got["tgt_lens"].numpy(), want["tgt_lens"])
    _assert_outputs(got, want)


def test_teacher_forced_forward_matches_jax(wide):
    _, model = _port_model(wide)
    got = model.eval().forward_teacher_forced(batch_to_device(wide["batch"], "cpu"))
    want = wide["teacher"]
    assert got["output"].shape[1] == wide["batch"]["mel"].shape[1]
    np.testing.assert_array_equal(got["duration_target"].numpy(), want["duration_target"])
    _assert_outputs(got, want)


def test_train_step_matches_jax(wide):
    cfg, model = _port_model(wide)
    params = list(model.named_parameters())
    opt = AdamWNoam(params, cfg.training)
    ema = [p.detach().clone() for _, p in params]
    got = train_step(model, opt, cfg, batch_to_device(wide["batch"], "cpu"), 0, EPOCH, ema)
    assert set(got) == set(wide["losses"])
    for name, value in wide["losses"].items():
        assert abs(float(got[name]) - value) <= ATOL, (name, float(got[name]), value)
    for name, value in model.state_dict().items():
        err = (value.float() - wide["end"][name].float()).abs()
        if name.endswith("in_proj_bias"):  # its key rows' gradient is zero to rounding
            d = err.shape[0] // 3
            assert float(err[d: 2 * d].max()) <= NOISE_ATOL, name
            err = torch.cat([err[:d], err[2 * d:]])
        noisy = (".conv_module.sequential.2.bias", ".conv_module.sequential.3.running_mean")
        assert float(err.max()) <= (NOISE_ATOL if name.endswith(noisy) else ATOL), name


# -- the attention padding step -----------------------------------------------

B, H, T = 2, 2, 40
P_SEED = 1234


def _attention_inputs(dh):
    rng = np.random.default_rng(dh)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, T, dh)).astype(np.float32))
                   for _ in range(4))
    valid = np.arange(T)[None, :] < np.array([[T], [23]])
    bias = torch.from_numpy(np.where(valid, 0.0, attention.NEG_INF).astype(np.float32))
    return q, k, v, do, bias


def _plain_fwd(q, k, v, bias, scale, p, seed, with_lse):
    """The plain version standing in for kernel A: refuses a width the
    kernels are not built for, returns (o, lse) in the op's layout."""
    assert q.shape[-1] in attention.KERNEL_HEAD_DIMS
    return attention._attention_fwd_cpu(q, k, v, bias, scale, p, seed, with_lse)


def _plain_bwd(q, k, v, o, do, bias, seed, p, scale):
    assert q.shape[-1] in attention.KERNEL_HEAD_DIMS
    return attention.attention_bwd_reference(q, k, v, bias, seed, p, scale, do)


def _rel(got, want):
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("dh", [16, 24, 48, 96, 160, 200, 256])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_padding_step_with_plain_versions_equals_them_unpadded(dh, p):
    q, k, v, do, bias = _attention_inputs(dh)
    seed = torch.tensor([P_SEED], dtype=torch.int32)
    scale = 1.0 / math.sqrt(dh)
    o, lse = attention.padded_fwd(_plain_fwd, q, k, v, bias, scale, p, seed, True)
    want_o, want_lse = attention._attention_fwd_cpu(q, k, v, bias, scale, p, seed, True)
    assert o.shape == q.shape and o.stride() == want_o.stride()
    assert _rel(o, want_o) <= PAD_REL and _rel(lse, want_lse) <= PAD_REL
    grads = attention.padded_bwd(_plain_bwd, q, k, v, o, do, bias, seed, p, scale)
    want = attention.attention_bwd_reference(q, k, v, bias, seed, p, scale, do)
    for got, ref in zip(grads, want):
        assert got.shape == q.shape
        assert got.is_contiguous() or dh in attention.KERNEL_HEAD_DIMS  # sliced back
        assert _rel(got, ref) <= PAD_REL


@pytest.mark.parametrize("dh,width", [(1, 64), (64, 64), (65, 128), (129, 192), (192, 192),
                                      (193, 256), (256, 256), (257, 384), (385, 512)])
def test_kernel_head_dim_is_the_next_build(dh, width):
    assert attention.kernel_head_dim(dh) == width


# -- the MRF gate and zero-channel padding ----------------------------------------

DILATION_SETS = ([tuple(d) for d in itertools.product((1, 2, 3, 5, 7, 9), repeat=3)]
                 + [(d,) for d in range(1, 64)])


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13])
def test_mrf_gate_equals_jax_gate(k):
    """Stages of one resblock (k, dilations) over every C from 1 to 256, and
    of three (k with 3 and 7 beside it) on the dilation triples."""
    for dils in DILATION_SETS:
        stages = [((k,), (dils,))]
        if len(dils) == 3:
            stages.append(((3, k, 7), ((1, 3, 5), dils, (1, 2, 3))))
        for ks, ds in stages:
            for C in range(1, 257):
                assert port_mrf.mrf_stage_supported(C, ks, ds) == \
                    jax_mrf.mrf_stage_supported(C, ks, ds), (C, ks, ds)


KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def _stage_blocks(C, seed):
    rng = np.random.default_rng(seed)
    blocks = []
    for k in KS:
        p = {}
        for i in range(3):
            for name in ("convs1", "convs2"):
                w = rng.standard_normal((C, C, k)) / math.sqrt(k * C)
                p[f"{name}.{i}.weight"] = torch.from_numpy(w.astype(np.float32))
                p[f"{name}.{i}.bias"] = torch.from_numpy(
                    (0.1 * rng.standard_normal(C)).astype(np.float32))
        blocks.append(p)
    return blocks


@pytest.mark.parametrize("C", [8, 16, 24, 48, 96])
def test_mrf_stage_with_zero_channels_equals_the_unpadded_stage(C):
    """``prepare_stage_weights`` pads to the route's width with zeros (none
    at C 8 and 16, the whole-stage kernel's widths) and ``fused_mrf_stage``
    pads its input; on the CPU the route's plain version runs on the
    prepared (split bf16) weights, so the reference is the unpadded plain
    stage on the same weights rebuilt in f32."""
    width = port_mrf.kernel_channels(C)
    blocks = _stage_blocks(C, C)
    flat = port_mrf.prepare_stage_weights(blocks, KS, DILS, torch.float32)
    assert flat[0].shape == (2, 3, width, width) and flat[1].shape == (width,)
    assert not flat[0][:, :, C:].any() and not flat[0][..., C:].any() and not flat[1][C:].any()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 300, C)).astype(np.float32))
    got = port_mrf.fused_mrf_stage(x, flat, KS, DILS)
    rebuilt = [{n: port_mrf.split_bf16(w).float().sum(0) if n.endswith("weight") else w
                for n, w in p.items()} for p in blocks]
    want = port_mrf.mrf_stage_reference(x, rebuilt, KS, DILS)
    assert got.shape == x.shape
    assert _rel(got, want) <= PAD_REL


EVEN_KS, EVEN_DILS = (4,), ((1, 3, 5),)


def test_mrf_stage_at_an_even_kernel_size_pads_as_same_where_jax_fused_kernel_shifts():
    """A stage of k 4 at dilations 1, 3 and 5, which both gates fuse. The
    port's stage (on the CPU, each conv's plain version with the kernel's
    offsets) pads as SAME does, (k - 1) * d // 2 before, and equals the JAX
    package's unfused golden. JAX's fused kernel shifts by (k - 1) // 2 * d,
    which differs at d 3 and 5, so its output leaves the golden: the
    difference ROADMAP.md lists."""
    C, T = 16, 300
    assert port_mrf.mrf_stage_supported(C, EVEN_KS, EVEN_DILS)
    assert jax_mrf.mrf_stage_supported(C, EVEN_KS, EVEN_DILS)
    rng = np.random.default_rng(11)
    jax_block = {}
    for i in range(len(EVEN_DILS[0])):
        for name in ("convs1", "convs2"):
            w = rng.standard_normal((EVEN_KS[0], C, C)) / math.sqrt(EVEN_KS[0] * C)
            jax_block[f"{name}_{i}_w"] = w.astype(np.float32)
            jax_block[f"{name}_{i}_b"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    port_block = {f"{name}.{i}.{kind}": torch.from_numpy(
        jax_block[f"{name}_{i}_{kind[0]}"].transpose(2, 1, 0).copy() if kind == "weight"
        else jax_block[f"{name}_{i}_{kind[0]}"])
        for i in range(len(EVEN_DILS[0])) for name in ("convs1", "convs2")
        for kind in ("weight", "bias")}
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    golden = torch.from_numpy(
        jax_mrf._np_reference_stage(x, [jax_block], EVEN_KS, EVEN_DILS).astype(np.float32))
    jax_fused = torch.from_numpy(np.asarray(jax_mrf.fused_mrf_stage(
        jnp.asarray(x), jax_mrf.prepare_stage_weights([jax_block], EVEN_KS, EVEN_DILS,
                                                      jnp.float32),
        EVEN_KS, EVEN_DILS, block_t=256, interpret=True)))
    flat = port_mrf.prepare_stage_weights([port_block], EVEN_KS, EVEN_DILS, torch.float32)
    port = port_mrf.fused_mrf_stage(torch.from_numpy(x), flat, EVEN_KS, EVEN_DILS)
    assert _rel(port, golden) <= 1e-5
    assert _rel(jax_fused, golden) > 0.1


# -- HiFiGAN V2 ------------------------------------------------------------------

V2 = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
          upsample_initial_channel=128, resblock_kernel_sizes=(3, 7, 11),
          resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)))


def test_hifigan_v2_fused_matches_jax_vocoder_fn(monkeypatch):
    jcfg = jax_hifigan.HiFiGANConfig(**V2)
    params = jax_hifigan.init_random_hifigan(jcfg, seed=5)
    # the init's 0.02 scale keeps activations near zero; widen it so the
    # comparison sees non-trivial values
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, params)
    mel = np.random.default_rng(6).standard_normal((2, 40, 80)).astype(np.float32)
    want, sr = jax_hifigan.make_vocoder_fn(params, jcfg)(mel)
    cfg = port_hifigan.HiFiGANConfig(**V2)
    fused_shapes = []

    def counting(x, *args):
        fused_shapes.append(tuple(x.shape))
        return port_mrf.fused_mrf_stage(x, *args)

    monkeypatch.setattr(port_hifigan, "fused_mrf_stage", counting)
    vocoder = port_hifigan.make_vocoder_fn(hifigan_state_from_jax(params, cfg), cfg,
                                           fused=True, device="cpu")
    got, got_sr = vocoder(mel)
    assert fused_shapes == [(2, 320, 64), (2, 2560, 32), (2, 5120, 16), (2, 10240, 8)]
    assert got_sr == sr and got.shape == want.shape == (2, 40 * 256)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
