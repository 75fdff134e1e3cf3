"""The PyTorch port's training attention (``attention_with_dropout``) against
the JAX package's dropout attention kernels, on the CPU.

At p = 0 the plain version's output and its dQ, dK, dV (autograd) agree
within max-abs 1e-5 with the JAX full-row kernel and the streaming kernel,
both in Pallas interpret mode, on odd T and dh 64 and 128. At p > 0 the two
packages draw different masks by design (the JAX kernel uses the TPU's
generator), so the port's mask is held to its own contract: the same seed
gives the same output and another seed another, the drop share lies within
binomial bounds, the output averaged over many seeds is the p = 0 output,
and entry (b, h, i, j) of the mask does not change when T is padded."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.ops.attention_dropout import (
    NEG_INF,
    attention_with_dropout as j_attention,
    attention_with_dropout_auto as j_attention_auto,
)
from fastspeech2_lightning_tpu_torch.ops.attention import (
    attention_dropout_reference,
    attention_with_dropout,
    dropout_keep_mask,
    dropout_threshold,
)

torch.set_num_threads(2)


def _inputs(seed, B, H, T, dh):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(4))
    lens = np.array([T, T - 7][:B])
    bias = np.where(np.arange(T)[None] < lens[:, None], 0.0, NEG_INF).astype(np.float32)
    return q, k, v, w, bias


def _port(q, k, v, w, bias, seed, p, scale):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = attention_with_dropout(*ts, torch.from_numpy(bias),
                               torch.tensor([seed], dtype=torch.int32), p, scale)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("kernel", ["full_row", "streaming"])
@pytest.mark.parametrize("T,dh", [(37, 64), (45, 128)])
def test_p0_matches_jax_kernels_in_interpret_mode(kernel, T, dh):
    q, k, v, w, bias = _inputs(0, 2, 2, T, dh)
    scale = 1.0 / math.sqrt(dh)
    fn = j_attention if kernel == "full_row" else j_attention_auto  # auto: streaming off-TPU
    seed = jnp.asarray([5], jnp.int32)

    def loss(q, k, v):
        o = fn(q, k, v, jnp.asarray(bias), seed, 0.0, scale)
        return jnp.sum(o * w), o

    (_, j_out), j_grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, grads = _port(q, k, v, w, bias, 5, 0.0, scale)
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=0, atol=1e-5)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_same_seed_same_output_other_seed_other_output():
    q, k, v, w, bias = _inputs(1, 2, 2, 40, 64)
    a, ga = _port(q, k, v, w, bias, 11, 0.2, 0.125)
    b, gb = _port(q, k, v, w, bias, 11, 0.2, 0.125)
    c, _ = _port(q, k, v, w, bias, 12, 0.2, 0.125)
    np.testing.assert_array_equal(a, b)
    for x, y in zip(ga, gb):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a - c).max() > 1e-2


@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
def test_drop_share_lies_within_binomial_bounds(p):
    keep = dropout_keep_mask(-123456789, 3, 2, 128, p)
    n = keep.numel()
    dropped = n - int(keep.sum())
    sigma = math.sqrt(n * p * (1 - p))
    assert abs(dropped - n * p) <= 5 * sigma
    # threshold of _uniform_keep: floor(p * 2^32)
    assert dropout_threshold(p) == int(p * 2**32)


def test_mean_over_seeds_is_the_p0_output():
    q, k, v, _, bias = _inputs(2, 1, 2, 24, 64)
    args = [torch.from_numpy(x) for x in (q, k, v, bias)]
    want = attention_dropout_reference(*args, None, 0.0, 0.125).numpy()
    outs = np.stack([
        attention_dropout_reference(*args, torch.tensor([s], dtype=torch.int32), 0.2,
                                    0.125).numpy()
        for s in range(600)
    ])
    z = (outs.mean(0) - want) / (outs.std(0) / math.sqrt(len(outs)))
    assert np.abs(z).max() <= 6.0
    assert abs(np.abs(z).mean() - math.sqrt(2 / math.pi)) <= 0.1


def test_mask_entries_do_not_depend_on_padding():
    small = dropout_keep_mask(77, 2, 3, 50, 0.3)
    padded = dropout_keep_mask(77, 2, 3, 128, 0.3)
    assert torch.equal(small, padded[:, :, :50, :50])
