"""The port's NumPy YIN (``preprocessing/f0.py``) against the JAX package's
C++ YIN (``native/kernels.cpp``), which the JAX package's preprocessing runs
where g++ builds it: on seeded harmonic signals with vibrato, silences and
noise bursts, and on white noise, the two give the same voicing and the
same f0, frame for frame (exactly; skipped where g++ cannot build the
C++ tracker)."""

import numpy as np
import pytest

from fastspeech2_lightning_tpu import native
from fastspeech2_lightning_tpu_torch.preprocessing.f0 import estimate_f0

SR, HOP = 22050, 256


def _voice(rng, seconds: float) -> np.ndarray:
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 300) * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    x[int(0.4 * n): int(0.5 * n)] = 0.0  # a silence
    burst = slice(int(0.7 * n), int(0.75 * n))
    x[burst] = rng.standard_normal(burst.stop - burst.start)  # a noise burst
    return (0.3 * x).astype(np.float32)


@pytest.fixture(scope="module")
def cpp_yin():
    if not native.available():
        pytest.skip("the JAX package's C++ YIN needs g++ to build")
    return native.yin_f0_native


@pytest.mark.parametrize("kind", ["voice", "noise"])
def test_numpy_yin_equals_the_cpp_yin(cpp_yin, kind):
    rng = np.random.default_rng(17)
    if kind == "voice":
        signals = [_voice(rng, s) for s in rng.uniform(1, 3, 6)]
    else:
        signals = [(0.3 * rng.standard_normal(2 * SR)).astype(np.float32)]
    for audio in signals:
        got = estimate_f0(audio, SR, HOP)
        want = cpp_yin(audio, SR, HOP, len(got), 71.0, 800.0, 0.25)
        if kind == "voice":
            assert (got > 0).mean() > 0.5
        np.testing.assert_array_equal(got, want)
