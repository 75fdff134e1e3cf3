"""The shapes past the kernels' earlier reach, on the CPU: head dims above
256 and texts of 1024 symbols or more, against the JAX package.

- The attention wrappers' padding step (``padded_fwd``, ``padded_bwd``)
  composed with the plain versions at dh 257 to 768, p 0 and 0.2, against
  the plain versions unpadded: rel-L2 at most 1e-6 in f32
  (``test_torch_widths.py``'s ``PAD_REL``); ``kernel_head_dim`` over dh 1
  to 1024: the next build up to 256, the next multiple of 128 above.
- The port's ``attention_reference`` against JAX's
  ``attention_with_dropout_padded`` (interpret mode, p 0) and the eval
  conformer's einsum path at dh 320 and 384: max-abs 1e-5.
- A d-320, 1-head (dh 320), 1 + 1-layer FastSpeech2 through the weight
  bridge against the JAX model: inference, teacher-forced forward and one
  training step at ``test_torch_widths.py``'s tolerances (max-abs 1e-4,
  with its allowance for the entries whose gradient is zero to rounding).
- ``mas_width1_reference`` against JAX's ``mas_width1_batched`` at L 1030
  and 2050 (T >= L): equal. The CTC forward-sum loss and its gradient
  against JAX's ``ctc_forward_sum`` at S 2061 and 4101, on alignment-shaped
  scores: loss within relative 1e-5 and gradient within max-abs 1e-5
  (``test_torch_train_ops.py``'s tolerance; the test says why not on
  uniformly drawn scores). Both again at L 8193 over 8200 frames, B 1: a
  text past one cluster's reach, which the kernels run in panels (about
  50 s and 6 GB together).
- A tiny-config training step at ``model.max_length`` 1100 on texts of
  1030 and 1100 symbols against JAX's, under a narrow diagonal prior (the
  test says why): MAS durations equal, the port's MAS on JAX's soft
  attention equal to JAX's, losses and parameters within max-abs 1e-4
  (with the same allowance).
- ``torch.library.opcheck`` of the op ``fs2t::attention_fwd`` at dh 384.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
from fastspeech2_lightning_tpu.ops import ctc as jctc
from fastspeech2_lightning_tpu.ops import mas as jmas
from fastspeech2_lightning_tpu.ops.attention_dropout import attention_with_dropout_padded
from fastspeech2_lightning_tpu.training.state import create_train_state
from fastspeech2_lightning_tpu.training.step import make_train_step
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import state_dict_from_jax
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.ops import attention
from fastspeech2_lightning_tpu_torch.ops import ctc as tctc
from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1_reference
from fastspeech2_lightning_tpu_torch.training.state import AdamWNoam
from fastspeech2_lightning_tpu_torch.training.step import (
    batch_to_device,
    step_generator,
    train_step,
)

from helpers import synthetic_batch, tiny_config, tiny_stats

torch.set_num_threads(2)

PAD_REL = 1e-6
ATOL = 1e-4
LR = 1e-3
NOISE_ATOL = 2 * LR  # one step: see test_torch_train_step.py
EPOCH = 50
N_SYMBOLS = 30


def _rel(got, want):
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


# -- the padding step and the width rule ----------------------------------------

B, H, T = 2, 1, 40
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
    kernels do not run as it is, returns (o, lse) in the op's layout."""
    assert attention._kernel_takes(q.shape[-1])
    return attention._attention_fwd_cpu(q, k, v, bias, scale, p, seed, with_lse)


def _plain_bwd(q, k, v, o, do, bias, seed, p, scale):
    assert attention._kernel_takes(q.shape[-1])
    return attention.attention_bwd_reference(q, k, v, bias, seed, p, scale, do)


@pytest.mark.parametrize("dh", [257, 320, 384, 512, 640, 768])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_padding_step_above_256_with_plain_versions_equals_them_unpadded(dh, p):
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
        assert _rel(got, ref) <= PAD_REL


@pytest.mark.parametrize("start", range(1, 1025, 128))
def test_kernel_head_dim_follows_the_width_rule(start):
    """The least of 64, 128, 192 and 256 that holds dh, and above 256 the
    next multiple of 128 (the JAX package's ``_round_up_128``)."""
    for dh in range(start, start + 128):
        width = attention.kernel_head_dim(dh)
        if dh <= 256:
            assert width == min(w for w in attention.KERNEL_HEAD_DIMS if w >= dh), dh
        else:
            assert width == -(-dh // 128) * 128, dh
        assert attention._kernel_takes(width)


# -- the plain attention against the JAX package at wide head dims -----------------


def _wide_inputs(dh, T=48, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, 1, T, dh)).astype(np.float32) for _ in range(3))
    lens = np.array([T, T - 17])
    key_bias = np.where(np.arange(T)[None, :] < lens[:, None], 0.0,
                        attention.NEG_INF).astype(np.float32)
    return q, k, v, key_bias


def _port_attention(q, k, v, key_bias):
    t = [torch.as_tensor(a) for a in (q, k, v, key_bias)]
    return attention.attention_reference(*t, 1.0 / np.sqrt(q.shape[-1])).numpy()


@pytest.mark.parametrize("dh", [320, 384])
def test_reference_matches_jax_padded_kernel_at_wide_head_dims(dh):
    q, k, v, key_bias = _wide_inputs(dh)
    want = attention_with_dropout_padded(
        *(jnp.asarray(a) for a in (q, k, v, key_bias)),
        jnp.zeros((1,), jnp.int32), 0.0, float(1.0 / np.sqrt(dh)))
    np.testing.assert_allclose(_port_attention(q, k, v, key_bias), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dh", [320, 384])
def test_reference_matches_jax_einsum_path_at_wide_head_dims(dh):
    q, k, v, key_bias = _wide_inputs(dh, seed=1)
    qt, kt, vt = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    scores = jnp.einsum("bqhd,bkhd->bhqk", qt, kt, preferred_element_type=jnp.float32)
    scores = scores / jnp.sqrt(dh)
    weights = jax.nn.softmax(scores + jnp.asarray(key_bias)[:, None, None, :], axis=-1)
    want = jnp.einsum("bhqk,bkhd->bqhd", weights.astype(vt.dtype), vt).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_port_attention(q, k, v, key_bias), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("p,with_lse", [(0.0, True), (0.2, False)])
def test_attention_op_passes_opcheck_at_a_wide_head_dim(p, with_lse):
    q, k, v, key_bias = (torch.from_numpy(a) for a in _wide_inputs(384, T=24, seed=2))
    seed = torch.tensor([7], dtype=torch.int32) if p > 0 else None
    torch.library.opcheck(torch.ops.fs2t.attention_fwd.default,
                          (q, k, v, key_bias, 0.05, p, seed, with_lse))


# -- a 1-head d-320 model through the weight bridge ----------------------------------

D, FF, T_MAX = 320, 640, 64


def _port_state_dict(state, cfg, stats):
    tree = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats, state.constants))
    return {k: torch.from_numpy(np.array(v))
            for k, v in state_dict_from_jax(*tree, cfg, stats).items()}


def _jax_state(cfg, stats, model, batch):
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch)
    vp = cfg.model.variance_predictors
    return state.replace(constants={"variance_adaptor": {
        "pitch_bins": jnp.linspace(stats.pitch.norm_min, stats.pitch.norm_max,
                                   vp.pitch.n_bins - 1),
        "energy_bins": jnp.linspace(stats.energy.norm_min, stats.energy.norm_max,
                                    vp.energy.n_bins - 1),
    }})


def _no_dropout(cfg):
    for conf in (cfg.model.encoder, cfg.model.decoder):
        conf.dropout = 0.0
    vp = cfg.model.variance_predictors
    for conf in (vp.pitch, vp.energy, vp.duration):
        conf.dropout = 0.0
    cfg.training.ema_decay = 0.9
    cfg.training.optimizer.warmup_steps = 1
    cfg.training.optimizer.learning_rate = LR
    return cfg


def one_head_config():
    """d 320 with one head (dh 320, which the attention kernels run at 384),
    feed-forward 2 d, 1 + 1 layers, no dropout and no PostNet."""
    cfg = tiny_config(dtype="float32", max_mel_length=T_MAX, use_postnet=False)
    for conf in (cfg.model.encoder, cfg.model.decoder):
        conf.input_dim, conf.heads, conf.feedforward_dim = D, 1, FF
    vp = cfg.model.variance_predictors
    for conf in (vp.pitch, vp.energy, vp.duration):
        conf.input_dim = D
    return _no_dropout(cfg)


def _one_head_batch():
    batch = synthetic_batch(np.random.default_rng(0), B=2, L=10, T=40)
    batch["sample_weight"] = np.array([1.0, 1.0], np.float32)
    return batch


@pytest.fixture(scope="module")
def one_head():
    """The JAX model's initial state carried to the port, and the JAX
    outputs: inference, teacher-forced and one training step."""
    cfg, stats = one_head_config(), tiny_stats()
    assert cfg.model.encoder.input_dim // cfg.model.encoder.heads == 320
    model = JFastSpeech2(config=cfg, stats=stats, n_symbols=N_SYMBOLS)
    batch = _one_head_batch()
    state = _jax_state(cfg, stats, model, batch)
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


def _port_model(jcfg, state_dict):
    cfg = FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())
    model = FastSpeech2(cfg, n_symbols=N_SYMBOLS)
    model.load_state_dict(state_dict, strict=True)
    return cfg, model


CLOSE = ("duration_prediction", "pitch_prediction", "energy_prediction", "output")


def _assert_outputs(got, want):
    np.testing.assert_array_equal(got["duration_rounded"].numpy(), want["duration_rounded"])
    for key in CLOSE:
        np.testing.assert_allclose(got[key].float().numpy(), want[key], rtol=0, atol=ATOL,
                                   err_msg=key)


def _assert_state_close(got_state, want_state):
    for name, value in got_state.items():
        err = (value.float() - want_state[name].float()).abs()
        if name.endswith("in_proj_bias"):  # its key rows' gradient is zero to rounding
            d = err.shape[0] // 3
            assert float(err[d: 2 * d].max()) <= NOISE_ATOL, name
            err = torch.cat([err[:d], err[2 * d:]])
        noisy = (".conv_module.sequential.2.bias", ".conv_module.sequential.3.running_mean")
        assert float(err.max()) <= (NOISE_ATOL if name.endswith(noisy) else ATOL), name


def test_one_head_inference_forward_matches_jax(one_head):
    _, model = _port_model(one_head["cfg"], one_head["start"])
    b = one_head["batch"]
    with torch.inference_mode():
        got = model.eval()(torch.as_tensor(b["text"], dtype=torch.int64),
                           torch.as_tensor(b["src_lens"]), T_MAX)
    want = one_head["inference"]
    np.testing.assert_array_equal(got["tgt_lens"].numpy(), want["tgt_lens"])
    _assert_outputs(got, want)


def test_one_head_teacher_forced_forward_matches_jax(one_head):
    _, model = _port_model(one_head["cfg"], one_head["start"])
    got = model.eval().forward_teacher_forced(batch_to_device(one_head["batch"], "cpu"))
    want = one_head["teacher"]
    np.testing.assert_array_equal(got["duration_target"].numpy(), want["duration_target"])
    _assert_outputs(got, want)


def test_one_head_train_step_matches_jax(one_head):
    cfg, model = _port_model(one_head["cfg"], one_head["start"])
    params = list(model.named_parameters())
    opt = AdamWNoam(params, cfg.training)
    ema = [p.detach().clone() for _, p in params]
    got = train_step(model, opt, cfg, batch_to_device(one_head["batch"], "cpu"), 0, EPOCH, ema)
    assert set(got) == set(one_head["losses"])
    for name, value in one_head["losses"].items():
        assert abs(float(got[name]) - value) <= ATOL, (name, float(got[name]), value)
    _assert_state_close(model.state_dict(), one_head["end"])


# -- MAS and CTC at texts of 1024 symbols or more -----------------------------------


def _log_attn(L, T, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, L)).astype(np.float32)
    x[0, :, 1::3] = x[0, :, :1]  # exact ties between neighbours
    la = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return la.astype(np.float32), np.array([L, L - 7], np.int32), np.array([T, T - 13], np.int32)


@pytest.mark.parametrize("L,T", [(1030, 1100), (2050, 2100)])
def test_mas_reference_equals_jax_at_long_texts(L, T):
    la, in_lens, out_lens = _log_attn(L, T, L)
    want_hard, want_dur = jmas.mas_width1_batched(jnp.asarray(la), jnp.asarray(in_lens),
                                                  jnp.asarray(out_lens))
    hard, dur = mas_width1_reference(torch.from_numpy(la), torch.from_numpy(in_lens),
                                     torch.from_numpy(out_lens))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(want_hard))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(want_dur))
    assert dur.sum(1).tolist() == out_lens.tolist()


def _alignment_logits(L, T, in_lens, out_lens, seed):
    """Attention scores shaped like a learned alignment: a diagonal ridge
    from (0, 0) to (out_len - 1, in_len - 1), two symbols wide, under noise
    of scale 0.5."""
    rng = np.random.default_rng(seed)
    attn = 0.5 * rng.standard_normal((2, T, L))
    for b in range(2):
        centers = np.arange(T) / (out_lens[b] - 1) * (in_lens[b] - 1)
        attn[b] -= (np.arange(L)[None] - centers[:, None]) ** 2 / (2 * 2.0 ** 2)
    return attn.astype(np.float32)


@pytest.mark.parametrize("L,T", [(1030, 1100), (2050, 2100)])
def test_ctc_forward_sum_and_gradient_match_jax_at_long_texts(L, T):
    """On alignment-shaped scores, as the loss sees them in training. (On
    scores drawn uniformly, -log p is about 7 a frame, so |alpha| reaches
    7e3 at these lengths, where one ulp of alpha + beta - ll moves a
    gradient entry by 5e-4 of itself; the two frameworks' exp and log
    differ by such an ulp at rare entries, one in 2.3 million at L 1030.)"""
    in_lens = np.array([L, L - 9], np.int32)
    out_lens = np.array([T, T - 21], np.int32)
    attn = _alignment_logits(L, T, in_lens, out_lens, L)
    logits = np.concatenate([np.full((2, T, 1), -1.0, np.float32), attn], -1)
    logits = np.where(np.arange(L + 1)[None, None] > in_lens[:, None, None], jctc.NEG_INF,
                      logits).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    assert 2 * L + 1 in (2061, 4101)
    w = np.array([0.3, 1.0], np.float32)
    j_loss = jctc.ctc_forward_sum(jnp.asarray(lp), jnp.asarray(in_lens), jnp.asarray(out_lens))
    j_grad = jax.grad(lambda x: jnp.sum(jctc.ctc_forward_sum(
        x, jnp.asarray(in_lens), jnp.asarray(out_lens)) * w))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_(True)
    loss = tctc.ctc_forward_sum(x, torch.from_numpy(in_lens), torch.from_numpy(out_lens))
    (loss * torch.from_numpy(w)).sum().backward()
    assert bool(torch.isfinite(loss.detach()).all()) and float(loss.detach().min()) > 0
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=0, atol=1e-5)


PAST_ONE_CLUSTER = (8193, 8200)  # (L, T): past PANEL_L (MAS) and PANEL_S (CTC, S 16387)


def test_mas_reference_equals_jax_past_one_cluster():
    """B 1 at L 8193, T 8200: the plain version the panels are held to on
    the card against JAX's scan, bit for bit."""
    L, T = PAST_ONE_CLUSTER
    rng = np.random.default_rng(L)
    x = rng.standard_normal((1, T, L)).astype(np.float32)
    la = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    in_lens, out_lens = np.array([L], np.int32), np.array([T], np.int32)
    _, want_dur = jmas.mas_width1_batched(jnp.asarray(la), jnp.asarray(in_lens),
                                          jnp.asarray(out_lens))
    want_dur = np.asarray(want_dur)
    hard, dur = mas_width1_reference(torch.from_numpy(la), torch.from_numpy(in_lens),
                                     torch.from_numpy(out_lens))
    np.testing.assert_array_equal(dur.numpy(), want_dur)
    cols = np.repeat(np.arange(L), want_dur[0])  # JAX's path, row by row
    assert torch.equal(hard[0].argmax(1), torch.from_numpy(cols))
    assert float(hard.sum()) == T


def test_ctc_forward_sum_and_gradient_match_jax_past_one_cluster():
    """B 1 at L 8193 (S 16387), T 8200, on alignment-shaped scores: the
    loss within relative 1e-5 and the gradient within max-abs 1e-5 of JAX's,
    as at L 1030 and 2050."""
    L, T = PAST_ONE_CLUSTER
    in_lens, out_lens = np.array([L], np.int32), np.array([T], np.int32)
    rng = np.random.default_rng(L)
    attn = 0.5 * rng.standard_normal((1, T, L))
    centers = np.arange(T) / (T - 1) * (L - 1)
    attn[0] -= (np.arange(L)[None] - centers[:, None]) ** 2 / (2 * 2.0 ** 2)
    logits = np.concatenate([np.full((1, T, 1), -1.0, np.float32), attn.astype(np.float32)], -1)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    del attn, logits
    w = np.array([0.7], np.float32)
    j_loss = np.asarray(jctc.ctc_forward_sum(jnp.asarray(lp), jnp.asarray(in_lens),
                                             jnp.asarray(out_lens)))
    j_grad = np.asarray(jax.grad(lambda x: jnp.sum(jctc.ctc_forward_sum(
        x, jnp.asarray(in_lens), jnp.asarray(out_lens)) * w))(jnp.asarray(lp)))
    x = torch.from_numpy(lp).requires_grad_(True)
    loss = tctc.ctc_forward_sum(x, torch.from_numpy(in_lens), torch.from_numpy(out_lens))
    (loss * torch.from_numpy(w)).sum().backward()
    assert bool(torch.isfinite(loss.detach()).all()) and float(loss.detach().min()) > 0
    np.testing.assert_allclose(loss.detach().numpy(), j_loss, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), j_grad, rtol=0, atol=1e-5)


# -- a training step on texts of more than 1024 symbols -------------------------------

LONG_L, LONG_T = 1100, 1200


PRIOR_WIDTH = 2.0  # symbols


def _long_batch():
    """Two utterances of 1100 and 1030 symbols over 1200 and 1150 frames,
    with a diagonal attention prior PRIOR_WIDTH symbols wide."""
    batch = synthetic_batch(np.random.default_rng(3), B=2, L=LONG_L, T=LONG_T)
    for b, (n_in, n_out) in enumerate([(LONG_L, LONG_T), (1030, 1150)]):
        batch["src_lens"][b], batch["mel_lens"][b] = n_in, n_out
        batch["text"][b, n_in:] = 0
        for key in ("mel", "pitch", "energy"):
            batch[key][b, n_out:] = 0.0
        prior = np.zeros((LONG_T, LONG_L), np.float32)
        centers = np.arange(n_out) / max(n_out - 1, 1) * (n_in - 1)
        prior[:n_out, :n_in] = np.exp(-((np.arange(n_in)[None] - centers[:, None]) ** 2)
                                      / (2 * PRIOR_WIDTH ** 2))
        prior[:n_out] /= prior[:n_out].sum(-1, keepdims=True)
        batch["attn_prior"][b] = prior
    batch["sample_weight"] = np.array([1.0, 1.0], np.float32)
    return batch


def test_train_step_at_max_length_1100_matches_jax():
    """The prior is narrow (PRIOR_WIDTH): under ``synthetic_batch``'s prior,
    about 190 symbols wide at these lengths, the untrained soft attention is
    near uniform and the two frameworks' f32 soft attentions (6.5e-9 apart)
    flip near-tied MAS decisions (10 of 2200 durations differed), while the
    port's MAS on JAX's soft attention gave JAX's durations exactly, as it
    must here too."""
    cfg = _no_dropout(tiny_config(dtype="float32", max_mel_length=LONG_T, use_postnet=False,
                                  max_length=LONG_L))
    stats = tiny_stats()
    model = JFastSpeech2(config=cfg, stats=stats, n_symbols=N_SYMBOLS)
    batch = _long_batch()
    assert batch["text"].shape[1] == LONG_L and sorted(batch["src_lens"]) == [1030, 1100]
    state = _jax_state(cfg, stats, model, batch)
    start = _port_state_dict(state, cfg, stats)
    out = model.apply({"params": state.params, "batch_stats": state.batch_stats,
                       "constants": state.constants}, batch, deterministic=False,
                      rngs={"dropout": jax.random.PRNGKey(9)}, mutable=["batch_stats"])[0]
    want_durations = np.asarray(out["duration_target"])
    jax_soft = torch.from_numpy(np.array(out["attn_soft"]))
    _, on_jax_soft = mas_width1_reference(torch.log(torch.clamp(jax_soft, min=1e-20)),
                                          torch.as_tensor(batch["src_lens"]),
                                          torch.as_tensor(batch["mel_lens"]))
    np.testing.assert_array_equal(on_jax_soft.numpy(), want_durations)
    state, losses = make_train_step(cfg, model)(state, batch, jax.random.PRNGKey(1), EPOCH)

    pcfg, pmodel = _port_model(cfg, start)
    assert pcfg.model.max_length == LONG_L
    db = batch_to_device(batch, "cpu")
    got_out = copy.deepcopy(pmodel).forward_train(db, step_generator(0, 0, "cpu"))
    np.testing.assert_array_equal(got_out["duration_target"].numpy(), want_durations)
    params = list(pmodel.named_parameters())
    opt = AdamWNoam(params, pcfg.training)
    ema = [p.detach().clone() for _, p in params]
    got = train_step(pmodel, opt, pcfg, db, 0, EPOCH, ema)
    assert set(got) == set(losses)
    for name, value in losses.items():
        assert abs(float(got[name]) - float(value)) <= ATOL, (name, float(got[name]),
                                                              float(value))
    _assert_state_close(pmodel.state_dict(), _port_state_dict(state, cfg, stats))
