"""Griffin-Lim mel inversion: a vocoder that needs no training (the
counterpart of the JAX package's ``synthesis/griffin_lim.py``).

Predicted log-mels are mapped back to linear-frequency magnitudes through
the regularized transposed mel filterbank, and the phases are recovered by
Griffin-Lim iteration (Griffin & Lim 1984). It keeps the port's vocoder
protocol (``vocoder(mel numpy [B, T, n_mels]) -> (wav numpy [B, T * hop],
sample rate)``, ``.device_fn(mel tensor) -> wav tensor``, ``.sample_rate``,
``.hop``), so the Synthesizer, the server and the wav writer take it where
they take a HiFiGAN; ``vocoder_path="griffin-lim"`` selects it.

The rows of a batch run together on the vocoder's device, in float64 as
the JAX package's numpy loop runs them. Each rebuilt STFT is cast to
complex64 as ``stft_complex_numpy`` casts it, and the initial phases of
row b come from ``np.random.default_rng(b)``'s draws (taken on the host,
turned into unit phasors on the device), so the result follows the JAX
package's within float rounding."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..preprocessing.features import mel_filterbank, stft_complex, stft_window

GRIFFIN_LIM_PATH = "griffin-lim"


def is_griffin_lim_path(path) -> bool:
    return str(path).lower() in (GRIFFIN_LIM_PATH, "griffin_lim", "gl")


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, F, n] frames -> [B, n + hop * (F - 1)] sums, each output sample
    summed over frames in increasing order (as a loop over the frames adds
    them). The frames are cut into ceil(n / hop) blocks of `hop` samples;
    block r of frame i lands on output block i + r."""
    B, F, n = frames.shape
    R = -(-n // hop)
    blocks = torch.nn.functional.pad(frames, (0, R * hop - n)).reshape(B, F, R, hop)
    out = frames.new_zeros(B, F + R - 1, hop)
    for r in range(R - 1, -1, -1):  # output block j gets frame j - r: frames in order
        out[:, r:r + F] += blocks[:, :, r]
    return out.reshape(B, -1)[:, : n + hop * (F - 1)]


def _istft(spec: torch.Tensor, n_fft: int, hop: int, win_length: int,
           length: int) -> torch.Tensor:
    """Inverse of ``stft_complex``: [B, T_frames, n_fft//2+1] complex128 ->
    [B, length] float32. Overlap-add with squared-window normalization (the
    synthesis window equals the analysis window), then removal of the center
    padding that the forward transform added."""
    window = torch.as_tensor(stft_window(n_fft, win_length), device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    out = _overlap_add(frames * window, hop)
    wsum = _overlap_add((window * window).expand(1, spec.shape[1], n_fft), hop)
    out = torch.where(wsum > 1e-8, out / torch.clamp(wsum, min=1e-8), out)
    pad = n_fft // 2
    return out[:, pad:pad + length].to(torch.float32)


def griffin_lim(mag: torch.Tensor, angles: torch.Tensor, n_fft: int, hop: int,
                win_length: int, n_iter: int = 48) -> torch.Tensor:
    """Phase recovery for [B, T_frames, n_fft//2+1] float64 magnitudes from
    initial phase angles (radians, float64, the same shape); returns
    [B, T_frames * hop] float32."""
    T = mag.shape[1]
    length = hop * T
    spec = torch.polar(mag, angles)
    for _ in range(n_iter):
        wav = _istft(spec, n_fft, hop, win_length, length)
        rebuilt = stft_complex(wav, n_fft, hop, win_length)[:, :T]
        if rebuilt.shape[1] < T:
            rebuilt = torch.nn.functional.pad(rebuilt, (0, 0, 0, T - rebuilt.shape[1]))
        # the unit phase as numpy's complex64 division by a real computes it:
        # each part times the float32 reciprocal of the modulus
        scale = 1.0 / torch.clamp(rebuilt.abs(), min=1e-10)
        spec = torch.complex(mag * (rebuilt.real * scale).to(torch.float64),
                             mag * (rebuilt.imag * scale).to(torch.float64))
    return _istft(spec, n_fft, hop, win_length, length)


class GriffinLimVocoder:
    """Mel -> wav by Griffin-Lim, on `device` (the current card unless
    "cpu" is asked for). Takes the model's predicted log-mels (natural log
    of mel-filterbank magnitudes) and returns [B, T * hop] float32 audio at
    the output sampling rate, each row scaled down to a peak of 1 where it
    exceeds 1. The filterbank is built at the input sampling rate."""

    def __init__(self, audio_cfg, n_iter: int = 48, device=None):
        self.a = audio_cfg
        self.n_iter = n_iter
        self.device = resolve_device(device)
        self.sample_rate = int(audio_cfg.output_sampling_rate)
        self.hop = int(audio_cfg.fft_hop_size)
        if audio_cfg.spec_type == "raw":
            raise ValueError(
                "griffin-lim fallback needs magnitude spectra; "
                "spec_type='raw' models carry complex STFTs"
            )
        if audio_cfg.spec_type == "linear":
            # log-linear magnitude models: no filterbank to invert
            fb_inv = np.eye(int(audio_cfg.n_fft) // 2 + 1)
        else:
            fb = mel_filterbank(
                int(audio_cfg.input_sampling_rate), int(audio_cfg.n_fft),
                int(audio_cfg.n_mels), float(audio_cfg.f_min),
                float(audio_cfg.f_max), audio_cfg.spec_type == "mel",
            )  # [n_mels, bins]
            # regularized transpose: the transpose over the squared column
            # norms, non-negative for non-negative inputs
            colnorm = np.maximum((fb * fb).sum(axis=0), 1e-8)  # [bins]
            fb_inv = (fb / colnorm[None, :]).T.astype(np.float64)
        self._fb_inv = torch.as_tensor(fb_inv, device=self.device)  # [bins, n_mels]

    def device_fn(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, T, n_mels] log-mel tensor -> [B, T * hop] float32 on the
        vocoder's device."""
        mel = mel.to(device=self.device, dtype=torch.float32)
        if mel.ndim == 2:
            mel = mel[None]
        lin = torch.clamp(torch.exp(mel.to(torch.float64)) @ self._fb_inv.T, min=0.0)
        # row b's initial phases are drawn on the host by a generator seeded
        # with b, as the JAX package draws them
        draws = np.stack([np.random.default_rng(b).random(lin.shape[1:])
                          for b in range(lin.shape[0])])
        angles = 2 * np.pi * torch.as_tensor(draws, device=self.device)
        a = self.a
        wav = griffin_lim(lin, angles, int(a.n_fft), self.hop, int(a.fft_window_size),
                          n_iter=self.n_iter)
        peak = wav.abs().amax(dim=1, keepdim=True)
        return torch.where(peak > 1.0, wav / peak, wav)

    def __call__(self, mels: np.ndarray):
        wav = self.device_fn(torch.as_tensor(np.asarray(mels, dtype=np.float32)))
        return wav.cpu().numpy(), self.sample_rate
