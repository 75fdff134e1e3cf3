"""The PyTorch port's mask, length-regulator and bucketize ops are exactly
equal to the JAX package's on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.ops.length_regulator import (
    length_regulate as jax_length_regulate,
)
from fastspeech2_lightning_tpu.ops.masking import mask_from_lens as jax_mask_from_lens
from fastspeech2_lightning_tpu.ops.variance import bucketize as jax_bucketize
from fastspeech2_lightning_tpu_torch.ops.length_regulator import length_regulate
from fastspeech2_lightning_tpu_torch.ops.masking import mask_from_lens
from fastspeech2_lightning_tpu_torch.ops.variance import bucketize

torch.set_num_threads(2)


def test_mask_from_lens_equal():
    lens = np.array([0, 3, 7, 10], dtype=np.int32)
    got = mask_from_lens(torch.as_tensor(lens), 10).numpy()
    want = np.asarray(jax_mask_from_lens(jnp.asarray(lens), 10))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_length", [40, 17])  # 17 truncates the long row
def test_length_regulate_equal(max_length):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, 5)).astype(np.float32)
    durs = rng.integers(0, 5, size=(3, 9)).astype(np.int32)
    durs[2, 5:] = 0  # ragged row
    ex, mask, lens = length_regulate(torch.as_tensor(x), torch.as_tensor(durs), max_length)
    jex, jmask, jlens = jax_length_regulate(jnp.asarray(x), jnp.asarray(durs), max_length)
    assert int(durs.sum(axis=1).max()) > 17
    np.testing.assert_array_equal(ex.numpy(), np.asarray(jex))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_bucketize_equal_including_boundaries():
    bins = np.linspace(-2.0, 2.0, 15, dtype=np.float32)
    rng = np.random.default_rng(1)
    vals = np.concatenate(
        [rng.uniform(-3, 3, 203).astype(np.float32), bins, bins[[0, -1]] - 1e-3,
         np.array([-1e9, 1e9], np.float32)]
    ).reshape(-1, 6)
    got = bucketize(torch.as_tensor(vals), torch.as_tensor(bins)).numpy()
    want = np.asarray(jax_bucketize(jnp.asarray(vals), jnp.asarray(bins)))
    np.testing.assert_array_equal(got, want)
    # a value on a boundary falls in the lower bucket
    assert got.reshape(-1)[203] == 0
