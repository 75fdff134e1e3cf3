"""The PyTorch port's attention (ops/attention.py) against the JAX package.

``attention_reference`` is the plain version of the CUDA kernel
``csrc/attention_fwd.cu``: it must equal the JAX Pallas kernel
``attention_with_dropout`` at p = 0 (run in interpret mode, as
tests/test_attention_dropout.py runs it) and the eval conformer's einsum
path (``models/conformer.py:177-186``), in f32 within max-abs 1e-5 (the
two sum in different orders). The kernel itself is held against this plain
version on the card by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.ops.attention_dropout import NEG_INF, attention_with_dropout
from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, attention_reference

torch.set_num_threads(2)

CASES = [(37, 64), (37, 128), (160, 64), (160, 128)]


def _inputs(T, dh, B=3, H=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(3))
    lens = np.array([T, T - 11, 5])[:B]  # ragged key masks
    key_bias = np.where(np.arange(T)[None, :] < lens[:, None], 0.0, NEG_INF).astype(np.float32)
    return q, k, v, key_bias


def _einsum_path(q, k, v, key_bias):
    """The JAX eval conformer's non-flash attention (conformer.py:177-186) on
    [B, H, T, dh] inputs."""
    dh = q.shape[-1]
    qt, kt, vt = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    scores = jnp.einsum("bqhd,bkhd->bhqk", qt, kt, preferred_element_type=jnp.float32)
    scores = scores / jnp.sqrt(dh)
    weights = jax.nn.softmax(scores + jnp.asarray(key_bias)[:, None, None, :], axis=-1)
    out = jnp.einsum("bhqk,bkhd->bqhd", weights.astype(vt.dtype), vt)
    return np.asarray(out.transpose(0, 2, 1, 3))


def _port(q, k, v, key_bias):
    t = [torch.as_tensor(a) for a in (q, k, v, key_bias)]
    return attention_reference(*t, 1.0 / np.sqrt(q.shape[-1])).numpy()


@pytest.mark.parametrize("T,dh", CASES)
def test_reference_matches_jax_kernel_p0(T, dh):
    q, k, v, key_bias = _inputs(T, dh)
    want = attention_with_dropout(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_bias),
        jnp.asarray([7], jnp.int32), 0.0, float(1.0 / np.sqrt(dh)),
    )
    np.testing.assert_allclose(_port(q, k, v, key_bias), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,dh", CASES)
def test_reference_matches_jax_einsum_path(T, dh):
    q, k, v, key_bias = _inputs(T, dh, seed=1)
    np.testing.assert_allclose(
        _port(q, k, v, key_bias), _einsum_path(q, k, v, key_bias), rtol=0, atol=1e-5
    )


def test_all_masked_row_is_uniform_average():
    """A batch row whose keys are all masked averages V uniformly, as the
    -1e9 bias gives in f32 (the kernel keeps the same finite bias)."""
    q, k, v, key_bias = _inputs(40, 64, B=2)
    key_bias[1] = NEG_INF
    got = _port(q, k, v, key_bias)
    np.testing.assert_allclose(
        got[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), got[1].shape), atol=1e-5
    )
    np.testing.assert_allclose(got, _einsum_path(q, k, v, key_bias), atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, key_bias = _inputs(37, 64)
    before = attention_fwd.launches
    t = [torch.as_tensor(a) for a in (q, k, v, key_bias)]
    out = attention_fwd(*t, 0.125)
    assert attention_fwd.launches == before
    np.testing.assert_array_equal(out.numpy(), attention_reference(*t, 0.125).numpy())
