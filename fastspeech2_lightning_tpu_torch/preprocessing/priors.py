"""The beta-binomial attention prior (counterpart of the JAX package's
``preprocessing/priors.py``): for mel frame t of T the prior over the L text
positions is BetaBinomial(L - 1; a = t * scale, b = (T + 1 - t) * scale),
a soft diagonal that steers the alignment attention early in training. The
JAX package calls ``betabinom`` once a frame; here one broadcast call gives
every row."""

from __future__ import annotations

import numpy as np
from scipy.stats import betabinom


def beta_binomial_prior(n_mel_frames: int, n_text: int,
                        scaling_factor: float = 1.0) -> np.ndarray:
    """[T_mel, L_text] float32 prior, each row a distribution."""
    T, L = n_mel_frames, n_text
    t = np.arange(1, T + 1, dtype=np.float64)[:, None]
    k = np.arange(L)[None, :]
    pmf = betabinom(L - 1, scaling_factor * t, scaling_factor * (T + 1 - t)).pmf(k)
    return np.asarray(pmf, dtype=np.float32).reshape(T, L)
