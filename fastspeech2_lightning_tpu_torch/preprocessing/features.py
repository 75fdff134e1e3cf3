"""Spectral features: the mel filterbank, the STFT and the log-mel.

Copies of the JAX package's ``preprocessing/features.py`` host functions
(``hz_to_mel``, ``mel_to_hz``, ``mel_filterbank``, ``_hann``,
``stft_complex_numpy``, ``stft_magnitude_numpy``, ``mel_spectrogram_numpy``:
what a style-reference wav and the host preprocessing pass compute, and
``frame_energy_numpy``), and ``stft_complex``, which computes what
``stft_complex_numpy`` computes on a batch of tensors on any device:
periodic Hann window, center padding by numpy's ``reflect`` rule (which
reflects again where the pad is wider than the signal), frames in float64,
the result cast to complex64; ``mel_spectrogram_torch``, the batched,
differentiable float32 log-mel of the vocoder trainer; and
``batched_mel_energy_torch``, the on-device preprocessing pass's log-mel and
energy from one float32 STFT."""

from __future__ import annotations

import functools

import numpy as np
import torch

LOG_CLIP = 1e-5


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if f.ndim:
        log_t = f >= min_log_hz
        mels = np.where(
            log_t, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels
        )
    elif f >= min_log_hz:
        mels = min_log_mel + np.log(f / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs = np.where(
            log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
        )
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float, htk: bool = False
) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular filterbank with slaney normalization
    (librosa.filters.mel parity for spec_type='mel-librosa')."""
    if f_max is None or f_max <= 0:
        f_max = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fb = np.zeros((n_mels, n_bins))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney normalization: equal area
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


def _hann(win_length: int) -> np.ndarray:
    # periodic hann (librosa/torch.stft convention)
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win_length) / win_length)


def stft_window(n_fft: int, win_length: int) -> np.ndarray:
    """The float64 analysis window, zero-padded to n_fft in the middle."""
    window = _hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def stft_complex_numpy(
    audio: np.ndarray, n_fft: int, hop: int, win_length: int
) -> np.ndarray:
    """[T_frames, n_fft//2+1] complex STFT; center=True, reflect padding."""
    pad = n_fft // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    window = stft_window(n_fft, win_length)
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop][:n_frames]
    return np.fft.rfft(frames * window[None, :], n=n_fft, axis=1).astype(
        np.complex64
    )


def stft_magnitude_numpy(audio: np.ndarray, n_fft: int, hop: int, win_length: int
                         ) -> np.ndarray:
    """[T_frames, n_fft//2+1] magnitude; center=True with reflect padding."""
    return np.abs(stft_complex_numpy(audio, n_fft, hop, win_length)).astype(np.float32)


def mel_spectrogram_numpy(audio: np.ndarray, sr: int, n_fft: int, hop: int, win_length: int,
                          n_mels: int, f_min: float, f_max: float,
                          spec_type: str = "mel-librosa") -> np.ndarray:
    """[n_mels, T_frames] log-mel, [n_fft//2+1, T] log-linear, or, for
    spec_type 'raw', the [n_fft//2+1, T] complex STFT with no log."""
    if spec_type == "raw":
        return stft_complex_numpy(audio, n_fft, hop, win_length).T
    return log_spectrogram(stft_magnitude_numpy(audio, n_fft, hop, win_length), sr, n_fft,
                           n_mels, f_min, f_max, spec_type)


def log_spectrogram(mag: np.ndarray, sr: int, n_fft: int, n_mels: int, f_min: float,
                    f_max: float, spec_type: str) -> np.ndarray:
    """The log-mel [n_mels, T] (or, for 'linear', log [bins, T]) of an
    STFT magnitude [T, bins]."""
    if spec_type == "linear":
        out = mag.T
    else:
        fb = mel_filterbank(sr, n_fft, n_mels, f_min, f_max, spec_type == "mel")
        out = fb @ mag.T  # [n_mels, T]
    return np.log(np.clip(out, LOG_CLIP, None)).astype(np.float32)


def frame_energy_numpy(audio: np.ndarray, n_fft: int, hop: int, win_length: int
                       ) -> np.ndarray:
    """[T_frames] frame energy: the L2 norm of the frame's STFT magnitudes
    (the FastSpeech2 convention)."""
    return energy_of(stft_magnitude_numpy(audio, n_fft, hop, win_length))


def energy_of(mag: np.ndarray) -> np.ndarray:
    """[T] frame energy of an STFT magnitude [T, bins]."""
    return np.linalg.norm(mag, axis=1).astype(np.float32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`pad` samples on both ends of the last axis (at least 2 samples long)
    by numpy's ``reflect`` rule: the signal mirrored about its end samples,
    again and again where the pad is longer than the signal (``F.pad``
    refuses that case)."""
    n = x.shape[-1]
    period = 2 * (n - 1)
    idx = torch.remainder(torch.arange(-pad, n + pad, device=x.device), period)
    return x[..., torch.where(idx < n, idx, period - idx)]


def stft_complex(audio: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """[..., T_frames, n_fft//2+1] complex64 STFT of [..., samples] audio:
    what ``stft_complex_numpy`` computes, row by row, on `audio`'s device."""
    pad = n_fft // 2
    x = reflect_pad(audio, pad)
    window = torch.as_tensor(stft_window(n_fft, win_length), device=audio.device)
    frames = x.unfold(-1, n_fft, hop).to(torch.float64) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).to(torch.complex64)


@functools.lru_cache(maxsize=16)
def _mel_constants(sr: int, n_fft: int, win_length: int, n_mels: int, f_min: float,
                   f_max: float, htk: bool, device: torch.device):
    """The f32 window and filterbank on `device`, copied there once (a copy
    from host memory would wait for the device's queue on every call)."""
    window = torch.as_tensor(stft_window(n_fft, win_length), dtype=torch.float32, device=device)
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, f_min, f_max, htk), device=device)
    return window, fb


def mel_spectrogram_torch(audio: torch.Tensor, sr: int, n_fft: int, hop: int, win_length: int,
                          n_mels: int, f_min: float, f_max: float, htk: bool = False
                          ) -> torch.Tensor:
    """[B, samples] -> [B, n_mels, T_frames] log-mel in float32,
    differentiable: the vocoder trainer's mel (the JAX package's
    ``mel_spectrogram_jax``, ``features.py:159-217``). Center reflect
    padding, the periodic Hann window, |rfft| (whose gradient at a zero bin
    is 0), the filterbank, then the LOG_CLIP floor and the log. Unlike
    ``stft_complex`` it stays in float32, as the JAX mel does."""
    mag = _magnitude(audio, sr, n_fft, hop, win_length, n_mels, f_min, f_max, htk)
    fb = _mel_constants(sr, n_fft, win_length, n_mels, f_min, f_max, htk, audio.device)[1]
    return torch.log(torch.clamp(torch.einsum("mf,btf->bmt", fb, mag), min=LOG_CLIP))


def _magnitude(audio, sr, n_fft, hop, win_length, n_mels, f_min, f_max, htk):
    """[B, T_frames, n_fft//2+1] f32 |STFT| of [B, samples] audio."""
    window = _mel_constants(sr, n_fft, win_length, n_mels, f_min, f_max, htk,
                            audio.device)[0]
    frames = reflect_pad(audio.float(), n_fft // 2).unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs()


def batched_mel_energy_torch(audio: torch.Tensor, sr: int, n_fft: int, hop: int,
                             win_length: int, n_mels: int, f_min: float, f_max: float,
                             htk: bool = False) -> tuple:
    """([B, n_mels, T] log-mel, [B, T] frame energy) of [B, samples] audio
    from one f32 STFT on `audio`'s device: the on-device preprocessing pass
    (the JAX package's ``batched_mel_energy_jax``, ``features.py:182-217``);
    the energy is the L2 norm of a frame's magnitudes."""
    mag = _magnitude(audio, sr, n_fft, hop, win_length, n_mels, f_min, f_max, htk)
    fb = _mel_constants(sr, n_fft, win_length, n_mels, f_min, f_max, htk, audio.device)[1]
    mel = torch.log(torch.clamp(torch.einsum("mf,btf->bmt", fb, mag), min=LOG_CLIP))
    return mel, torch.sqrt(torch.sum(mag * mag, dim=-1))
