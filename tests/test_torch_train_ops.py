"""The PyTorch port's training ops against the JAX package's, on the CPU.

The same numpy inputs go through both. average_variance is exactly equal on
inputs whose partial sums f32 holds exactly (multiples of 1/64), where the
two packages' different cumsum orders cannot matter, and within 1e-6 on
arbitrary ones. The plain MAS is exactly equal, path and durations, to the
scan version and to the Pallas kernel in interpret mode, ties included. The
plain CTC forward-sum agrees with the scan version within relative 1e-5 and
its gradient (the autograd Function's beta pass) with jax.grad within
max-abs 1e-5; the plain alphas agree with the Pallas banded scan in
interpret mode. The two alignment losses agree with and without sample
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.ops import ctc as jctc
from fastspeech2_lightning_tpu.ops.ctc_pallas import banded_lse_scan_pallas
from fastspeech2_lightning_tpu.ops.mas import NEG_INF as MAS_NEG_INF
from fastspeech2_lightning_tpu.ops.mas import mas_width1_batched
from fastspeech2_lightning_tpu.ops.mas_pallas import mas_width1_pallas
from fastspeech2_lightning_tpu.ops.variance import average_variance as j_average_variance
from fastspeech2_lightning_tpu_torch.ops import ctc as tctc
from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference
from fastspeech2_lightning_tpu_torch.ops.variance import average_variance

torch.set_num_threads(2)


def _durations(rng, B, L, T, src_lens):
    durs = np.zeros((B, L), np.int32)
    for b in range(B):
        n = src_lens[b]
        cut = np.sort(rng.choice(np.arange(1, T - 3), n - 1, replace=False))
        d = np.diff(np.concatenate([[0], cut, [T - 3 - b]]))
        durs[b, :n] = np.maximum(d, 0)
    return durs


@pytest.mark.parametrize("dyadic", [True, False])
def test_average_variance_matches_jax(dyadic):
    rng = np.random.default_rng(0)
    B, L, T = 3, 9, 60
    src_lens = np.array([9, 6, 4])
    durs = _durations(rng, B, L, T, src_lens)
    var = rng.standard_normal((B, T)).astype(np.float32)
    if dyadic:
        var = np.round(var * 64) / 64
    var[rng.random((B, T)) < 0.3] = 0.0  # unvoiced frames
    var[:, T - 5:] = 0.0  # padding
    got = average_variance(torch.from_numpy(var), torch.from_numpy(durs)).numpy()
    want = np.asarray(j_average_variance(jnp.asarray(var), jnp.asarray(durs)))
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[0, durs[0] == 0] == 0).all()


def _log_attn(rng, B, T, L, ties):
    la = np.log(rng.dirichlet(np.ones(L), size=(B, T))).astype(np.float32)
    if ties:
        # neighbouring columns with equal values force left >= stay ties
        la[:, :, 1::2] = la[:, :, 0::2][:, :, : L // 2]
        la[1] = np.round(la[1])
    return la


@pytest.mark.parametrize("ties", [False, True])
def test_plain_mas_equals_jax_scan_and_pallas_interpret(ties):
    rng = np.random.default_rng(1)
    B, T, L = 4, 48, 14
    la = _log_attn(rng, B, T, L, ties)
    in_lens = np.array([14, 9, 5, 1], np.int32)
    out_lens = np.array([48, 30, 17, 6], np.int32)
    hard, dur = mas_width1(torch.from_numpy(la), torch.from_numpy(in_lens),
                           torch.from_numpy(out_lens))
    j_hard, j_dur = mas_width1_batched(jnp.asarray(la), jnp.asarray(in_lens),
                                       jnp.asarray(out_lens))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(j_hard))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(j_dur))

    valid = ((np.arange(L)[None, None] < in_lens[:, None, None])
             & (np.arange(T)[None, :, None] < out_lens[:, None, None]))
    masked = np.where(valid, np.maximum(la, MAS_NEG_INF), MAS_NEG_INF).astype(np.float32)
    p_hard = np.asarray(mas_width1_pallas(jnp.asarray(masked), jnp.asarray(in_lens),
                                          jnp.asarray(out_lens), interpret=True))
    p_hard = p_hard * (np.arange(T)[None, :] < out_lens[:, None])[:, :, None]
    np.testing.assert_array_equal(hard.numpy(), p_hard)
    np.testing.assert_array_equal(dur.numpy(), p_hard.sum(1).astype(np.int32))
    assert (dur.numpy().sum(1) == out_lens).all()


def test_mas_reference_is_what_the_cpu_wrapper_runs():
    rng = np.random.default_rng(2)
    la = torch.from_numpy(_log_attn(rng, 2, 20, 6, False))
    lens = torch.tensor([6, 3]), torch.tensor([20, 11])
    before = mas_width1.launches
    for got, want in zip(mas_width1(la, *lens), mas_width1_reference(la, *lens)):
        assert torch.equal(got, want)
    assert mas_width1.launches == before


def _ctc_inputs(seed, B=3, T=40, L=7):
    rng = np.random.default_rng(seed)
    attn = (rng.standard_normal((B, T, L)) * 0.5).astype(np.float32)
    in_lens = np.array([L, L - 3, 2][:B], np.int32)
    out_lens = np.array([T, T - 11, 9][:B], np.int32)
    return attn, in_lens, out_lens


def _logprobs(attn, in_lens):
    B, T, L = attn.shape
    logits = np.concatenate([np.full((B, T, 1), -1.0, np.float32), attn], -1)
    logits = np.where(np.arange(L + 1)[None, None] > in_lens[:, None, None], jctc.NEG_INF,
                      logits).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def test_ctc_forward_sum_and_gradient_match_jax():
    attn, in_lens, out_lens = _ctc_inputs(3)
    lp = _logprobs(attn, in_lens)
    w = np.array([0.3, 1.0, 0.7], np.float32)
    j_loss = jctc.ctc_forward_sum(jnp.asarray(lp), jnp.asarray(in_lens), jnp.asarray(out_lens))
    j_grad = jax.grad(lambda x: jnp.sum(jctc.ctc_forward_sum(
        x, jnp.asarray(in_lens), jnp.asarray(out_lens)) * w))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_(True)
    loss = tctc.ctc_forward_sum(x, torch.from_numpy(in_lens), torch.from_numpy(out_lens))
    (loss * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=0, atol=1e-5)


def test_plain_alphas_match_pallas_banded_scan_interpret():
    attn, in_lens, out_lens = _ctc_inputs(4, B=2, T=40, L=5)
    lp = _logprobs(attn, in_lens)
    alphas = tctc.ctc_alpha(torch.from_numpy(lp), torch.from_numpy(out_lens)).numpy()
    y = jctc._uniform_logprobs(jnp.asarray(lp), jnp.asarray(out_lens))
    _, state_label, _ = jctc._state_maps(5)
    pallas = np.asarray(banded_lse_scan_pallas(y[:, :, state_label], left=False,
                                               add_emis_first=True, interpret=True))
    valid = pallas > 0.9 * jctc.NEG_INF
    np.testing.assert_array_equal(valid, alphas > 0.9 * tctc.NEG_INF)
    np.testing.assert_allclose(alphas[valid], pallas[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_alignment_losses_match_jax(weighted):
    attn, in_lens, out_lens = _ctc_inputs(5)
    sw = np.array([1.0, 1.0, 0.0], np.float32) if weighted else None
    j_sw = None if sw is None else jnp.asarray(sw)
    t_sw = None if sw is None else torch.from_numpy(sw)
    j_ctc, j_grad = jax.value_and_grad(lambda a: jctc.attention_ctc_loss(
        a, jnp.asarray(in_lens), jnp.asarray(out_lens), sample_weight=j_sw))(jnp.asarray(attn))
    x = torch.from_numpy(attn).requires_grad_(True)
    t_ctc = tctc.attention_ctc_loss(x, torch.from_numpy(in_lens), torch.from_numpy(out_lens),
                                    sample_weight=t_sw)
    t_ctc.backward()
    np.testing.assert_allclose(float(t_ctc), float(j_ctc), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=0, atol=1e-5)

    rng = np.random.default_rng(6)
    soft = rng.dirichlet(np.ones(7), size=(3, 40)).astype(np.float32)
    hard = np.eye(7, dtype=np.float32)[rng.integers(0, 7, size=(3, 40))]
    j_bin = jctc.attention_binarization_loss(jnp.asarray(hard), jnp.asarray(soft),
                                             sample_weight=j_sw)
    t_bin = tctc.attention_binarization_loss(torch.from_numpy(hard), torch.from_numpy(soft),
                                             sample_weight=t_sw)
    np.testing.assert_allclose(float(t_bin), float(j_bin), rtol=1e-6)
