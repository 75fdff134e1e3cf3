"""The PyTorch port's training-mode layers against the JAX package's, on the
CPU, f32, within max-abs 1e-5 (the frameworks sum in different orders).

- The conformer's MaskedBatchNorm with batch statistics: output and the
  updated running statistics (valid frames only, biased variance, momentum
  0.9).
- The PostNet with batch statistics over every position (flax nn.BatchNorm),
  against the JAX PostNet called with deterministic=True and
  use_running_average=False, which takes batch statistics without its fixed
  dropout.
- ConvAttention, with and without a prior.
- fast_dropout: the rate quantized to t/256, the drop share, and the
  rescale 256/(256 - t) that makes it unbiased."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models.attention import ConvAttention as JConvAttention
from fastspeech2_lightning_tpu.models.conformer import MaskedBatchNorm
from fastspeech2_lightning_tpu.models.layers import PostNet as JPostNet
from fastspeech2_lightning_tpu_torch import convert
from fastspeech2_lightning_tpu_torch.models.attention import ConvAttention
from fastspeech2_lightning_tpu_torch.models.layers import BatchNorm1d, PostNet, fast_dropout

torch.set_num_threads(2)
ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mask(B, T, lens):
    return np.arange(T)[None] < np.asarray(lens)[:, None]


def test_masked_batch_norm_statistics_match_jax():
    rng = np.random.default_rng(0)
    B, T, C = 3, 20, 8
    x = (rng.standard_normal((B, T, C)) * 2 + 1).astype(np.float32)
    mask = _mask(B, T, [20, 13, 4])
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                   "bias": rng.standard_normal(C).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(C).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, C).astype(np.float32)},
    }
    y, updated = MaskedBatchNorm().apply(variables, jnp.asarray(x), jnp.asarray(mask),
                                         use_running_average=False, mutable=["batch_stats"])
    bn = BatchNorm1d(C)
    bn.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0),
    })
    got = bn(torch.from_numpy(x), mask=torch.from_numpy(mask), use_running_average=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=ATOL)
    stats = _np_tree(updated["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=0, atol=ATOL)


def test_postnet_batch_statistics_match_jax():
    rng = np.random.default_rng(1)
    B, T, n_mels, dim = 2, 24, 20, 32
    x = rng.standard_normal((B, T, n_mels)).astype(np.float32)
    jmodel = JPostNet(n_mel_channels=n_mels, postnet_embedding_dim=dim)
    variables = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    for name in variables["batch_stats"]:
        C = variables["batch_stats"][name]["mean"].shape[0]
        variables["batch_stats"][name] = {"mean": rng.standard_normal(C).astype(np.float32),
                                          "var": rng.uniform(0.5, 2, C).astype(np.float32)}
    y, updated = jmodel.apply(variables, jnp.asarray(x), deterministic=True,
                              use_running_average=False, mutable=["batch_stats"])
    sd = {}
    for i in range(5):
        convert._conv1d(sd, f"convolutions.{i}.0.conv", variables["params"][f"conv_{i}"])
        convert._bn(sd, f"convolutions.{i}.1", variables["params"][f"bn_{i}"],
                    variables["batch_stats"][f"bn_{i}"])
    model = PostNet(n_mels=n_mels, dim=dim)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    got = model(torch.from_numpy(x), gen=None, use_running_average=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=ATOL)
    stats = _np_tree(updated["batch_stats"])
    for i in range(5):
        bn = model.convolutions[i][1]
        np.testing.assert_allclose(bn.running_mean.numpy(), stats[f"bn_{i}"]["mean"],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), stats[f"bn_{i}"]["var"],
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("with_prior", [False, True])
def test_conv_attention_matches_jax(with_prior):
    rng = np.random.default_rng(2)
    B, T, L, n_mels, d = 2, 30, 9, 20, 32
    mel = rng.standard_normal((B, T, n_mels)).astype(np.float32)
    text = rng.standard_normal((B, L, d)).astype(np.float32)
    key_mask = _mask(B, L, [9, 5])
    prior = rng.dirichlet(np.ones(L), size=(B, T)).astype(np.float32) if with_prior else None
    jmodel = JConvAttention(n_mel_channels=n_mels, n_text_channels=d, n_att_channels=n_mels)
    j_prior = None if prior is None else jnp.asarray(prior)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(mel), jnp.asarray(text),
                         jnp.asarray(key_mask), j_prior)
    j_attn, j_logprob = jmodel.apply(params, jnp.asarray(mel), jnp.asarray(text),
                                     key_mask=jnp.asarray(key_mask), attn_prior=j_prior)
    sd = {}
    convert._conv_attention(sd, "m", _np_tree(params)["params"])
    model = ConvAttention(n_mels, d, n_mels)
    model.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    attn, logprob = model(torch.from_numpy(mel), torch.from_numpy(text),
                          key_mask=torch.from_numpy(key_mask),
                          attn_prior=None if prior is None else torch.from_numpy(prior))
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(j_attn), rtol=0, atol=ATOL)
    np.testing.assert_allclose(logprob.detach().numpy(), np.asarray(j_logprob),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_fast_dropout_quantizes_the_rate_and_stays_unbiased(rate):
    x = torch.ones(64, 1024)
    gen = torch.Generator().manual_seed(0)
    y = fast_dropout(x, rate, gen)
    t = int(round(rate * 256))
    scale = torch.tensor(256.0 / (256 - t), dtype=torch.float32)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], float(scale)))
    n, dropped = x.numel(), int((~kept).sum())
    q = t / 256  # the quantized drop probability
    assert abs(dropped - n * q) <= 5 * math.sqrt(n * q * (1 - q))
    assert abs((1 - q) * float(scale) - 1.0) <= 1e-7  # E[y] = x
    assert torch.equal(fast_dropout(x, rate, None), x)
    assert torch.equal(fast_dropout(x, 1.0, gen), torch.zeros_like(x))
    assert torch.equal(fast_dropout(x, 0.001, gen), x)  # t = 0
