"""F0 (pitch) estimation: a copy of the JAX package's NumPy YIN tracker
(``preprocessing/f0.py:29-120``), its documented golden reference.

Frames at the spec hop (so pitch aligns with the mel frames); per frame the
difference function through zero-padded FFTs, the cumulative-mean
normalization, the first lag under the threshold (else the global minimum),
a descent to the local minimum and a parabolic refinement; unvoiced and
near-silent frames are 0. The JAX package runs a C++ YIN instead when g++
builds it (``native/kernels.cpp``); on seeded voiced signals and on noise
the two give the same voicing and the same f0, frame for frame
(``tests/test_torch_yin_native.py``). This package always runs the NumPy
tracker."""

from __future__ import annotations

import numpy as np


def _frame_signal(audio: np.ndarray, frame_len: int, hop: int, n_frames: int):
    pad = frame_len // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, frame_len)[::hop]
    return frames[:n_frames]


def estimate_f0(
    audio: np.ndarray,
    sr: int,
    hop: int,
    n_frames: int | None = None,
    f_min: float = 71.0,
    f_max: float = 800.0,
    threshold: float = 0.25,
) -> np.ndarray:
    """[T_frames] F0 in Hz, 0 where unvoiced."""
    tau_min = max(2, int(sr / f_max))
    tau_max = int(sr / f_min)
    frame_len = 2 * tau_max
    if n_frames is None:
        n_frames = 1 + len(audio) // hop
    frames = _frame_signal(audio.astype(np.float64), frame_len, hop, n_frames)
    n = frames.shape[0]
    if n < n_frames:  # very short audio: pad frames
        frames = np.concatenate(
            [frames, np.zeros((n_frames - n, frame_len))], axis=0
        )

    W = tau_max  # integration window
    # difference function d(tau) = sum_{j<W} (x[j] - x[j+tau])^2
    #                            = r0 + r_tau - 2 * corr_W(tau)
    # with corr_W(tau) = sum_{j<W} x[j] x[j+tau]: a windowed cross-correlation
    # of x[:W] against x, via zero-padded FFTs (linear, not circular).
    x = frames
    fsize = 1
    while fsize < frame_len + tau_max:
        fsize *= 2
    X = np.fft.rfft(x, fsize, axis=1)
    XW = np.fft.rfft(x[:, :W], fsize, axis=1)
    corr = np.fft.irfft(X * np.conj(XW), fsize, axis=1)[:, : tau_max + 1]

    # cumulative energy terms
    sq = x**2
    csum = np.concatenate(
        [np.zeros((x.shape[0], 1)), np.cumsum(sq, axis=1)], axis=1
    )
    r0 = csum[:, W] - csum[:, 0]  # energy of x[0:W]
    # energy of x[tau:tau+W] for each tau
    taus = np.arange(tau_max + 1)
    r_tau = csum[:, taus + W] - csum[:, taus]
    d = r0[:, None] + r_tau - 2 * corr  # [T, tau_max+1]
    d = np.maximum(d, 0.0)

    # cumulative mean normalized difference
    cum = np.cumsum(d[:, 1:], axis=1)
    cmnd = np.ones_like(d)
    cmnd[:, 1:] = d[:, 1:] * taus[1:][None, :] / np.maximum(cum, 1e-12)

    # pick the first tau under threshold, else global min, in [tau_min, tau_max]
    valid = cmnd[:, tau_min : tau_max + 1]
    under = valid < threshold
    first_under = np.argmax(under, axis=1)
    has_under = under.any(axis=1)
    global_min = np.argmin(valid, axis=1)
    tau_star = np.where(has_under, first_under, global_min) + tau_min

    # YIN refinement: descend from the threshold crossing to the local
    # minimum of the normalized difference (the crossing happens on the
    # falling edge, before the true period)
    n_frames_actual = cmnd.shape[0]
    k_max = max(8, tau_max // 3)
    offs = np.arange(k_max)
    win_idx = np.minimum(tau_star[:, None] + offs[None, :], tau_max)
    win = cmnd[np.arange(n_frames_actual)[:, None], win_idx]
    # allow descent only up to ~35% past the crossing
    limit = np.maximum(4, (tau_star * 0.35).astype(int))
    win = np.where(offs[None, :] <= limit[:, None], win, np.inf)
    tau_star = tau_star + np.argmin(win, axis=1)
    tau_star = np.minimum(tau_star, tau_max)

    # parabolic interpolation around the minimum
    t_idx = np.arange(cmnd.shape[0])
    tau0 = np.clip(tau_star, tau_min + 1, tau_max - 1)
    d0 = cmnd[t_idx, tau0 - 1]
    d1 = cmnd[t_idx, tau0]
    d2 = cmnd[t_idx, tau0 + 1]
    denom = 2.0 * (d0 - 2.0 * d1 + d2)
    delta = np.where(np.abs(denom) > 1e-12, (d0 - d2) / np.where(np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    delta = np.clip(delta, -1.0, 1.0)
    tau_refined = tau0 + delta

    f0 = sr / np.maximum(tau_refined, 1e-6)
    min_d = cmnd[t_idx, tau_star]
    voiced = (min_d < threshold * 2.0) & (f0 >= f_min) & (f0 <= f_max)
    # silence gate: frames with negligible energy are unvoiced
    frame_rms = np.sqrt(np.mean(sq[:, :W], axis=1))
    voiced &= frame_rms > max(1e-4, 0.02 * np.max(frame_rms + 1e-12))
    return np.where(voiced, f0, 0.0).astype(np.float32)
