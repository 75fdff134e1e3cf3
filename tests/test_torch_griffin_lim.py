"""The port's Griffin-Lim vocoder against the JAX package's, on the CPU.

The same seeded log-mels at B = 2 go through both ``GriffinLimVocoder``s:
for spec_type mel, mel-librosa and linear, at 4 iterations and at the
default 48 on a short mel, and on a 2-frame mel (whose 512 samples are
padded by 512 on each side, wider than numpy's reflection of the signal
covers in one pass). Float waveforms within max-abs 1e-5. ``raw`` spectra
are refused, the path sentinel is recognized, ``device_fn`` equals
``__call__``, and the port's STFT equals ``stft_complex_numpy``."""

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.config import FastSpeech2Config as JFastSpeech2Config
from fastspeech2_lightning_tpu.preprocessing.features import (
    stft_complex_numpy as j_stft_complex_numpy,
)
from fastspeech2_lightning_tpu.synthesis.griffin_lim import GriffinLimVocoder as JGriffinLim
from fastspeech2_lightning_tpu.synthesis.griffin_lim import (
    is_griffin_lim_path as j_is_griffin_lim_path,
)
from fastspeech2_lightning_tpu_torch.config import AudioConfig
from fastspeech2_lightning_tpu_torch.preprocessing.features import reflect_pad, stft_complex
from fastspeech2_lightning_tpu_torch.synthesis.griffin_lim import (
    GRIFFIN_LIM_PATH,
    GriffinLimVocoder,
    is_griffin_lim_path,
)

torch.set_num_threads(2)
ATOL = 1e-5


def _configs(spec_type):
    jaudio = JFastSpeech2Config().preprocessing.audio.model_copy(update={"spec_type": spec_type})
    return jaudio, AudioConfig(spec_type=spec_type)


def _log_mels(spec_type, frames, seed=0):
    channels = 513 if spec_type == "linear" else 80
    return (np.random.default_rng(seed).standard_normal((2, frames, channels)) - 2.0
            ).astype(np.float32)


@pytest.mark.parametrize("spec_type, frames, n_iter", [
    ("mel-librosa", 24, 4),
    ("mel", 24, 4),
    ("linear", 16, 4),
    ("mel-librosa", 12, 48),
    ("mel-librosa", 2, 48),
])
def test_griffin_lim_matches_jax(spec_type, frames, n_iter):
    jaudio, audio = _configs(spec_type)
    mels = _log_mels(spec_type, frames)
    want, want_sr = JGriffinLim(jaudio, n_iter=n_iter)(mels)
    got, sr = GriffinLimVocoder(audio, n_iter=n_iter, device="cpu")(mels)
    assert sr == want_sr == 22050
    assert got.dtype == np.float32 and got.shape == want.shape == (2, frames * 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert float(np.abs(want).max()) > 1e-3  # audible, not a row of zeros


def test_device_fn_equals_call():
    _, audio = _configs("mel-librosa")
    voc = GriffinLimVocoder(audio, n_iter=4, device="cpu")
    mels = _log_mels("mel-librosa", 10, seed=1)
    wav, _ = voc(mels)
    dev = voc.device_fn(torch.from_numpy(mels))
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), wav)
    assert voc.hop == 256 and voc.sample_rate == 22050


def test_raw_spectra_refused():
    jaudio, audio = _configs("raw")
    with pytest.raises(ValueError, match="magnitude spectra"):
        JGriffinLim(jaudio)
    with pytest.raises(ValueError, match="magnitude spectra"):
        GriffinLimVocoder(audio, device="cpu")


@pytest.mark.parametrize("path", ["griffin-lim", "GRIFFIN_LIM", "gl", "griffinlim",
                                  "hifigan.npz", GRIFFIN_LIM_PATH])
def test_path_sentinel(path):
    assert is_griffin_lim_path(path) == j_is_griffin_lim_path(path)


@pytest.mark.parametrize("n, pad", [(512, 512), (256, 512), (1000, 512), (7, 3), (2, 9)])
def test_stft_and_reflect_pad_match_numpy(n, pad):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(reflect_pad(torch.from_numpy(x), pad).numpy(),
                                  np.pad(x, (pad, pad), mode="reflect"))
    if n >= 256:
        got = stft_complex(torch.from_numpy(x)[None], 1024, 256, 1024)[0].numpy()
        want = j_stft_complex_numpy(x, 1024, 256, 1024)
        assert got.dtype == want.dtype == np.complex64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
