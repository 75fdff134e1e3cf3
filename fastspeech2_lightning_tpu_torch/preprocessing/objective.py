"""Objective audio-quality metrics (copies of the JAX package's
``preprocessing/objective.py:31-210``), for ``evaluate-vocoder``:

* ``si_sdr(estimate, reference)``: scale-invariant signal-to-distortion
  ratio in dB (Le Roux et al. 2019);
* ``stoi(clean, degraded, sr)``: short-time objective intelligibility
  (Taal et al. 2010), 1/3-octave band envelope correlations over 384 ms
  segments at 10 kHz;
* ``pesq_proxy(clean, degraded, sr)``: a PESQ-shaped MOS estimate (not ITU
  PESQ), for ranking.

and, for ``check-data`` (``:142-165``, ``:212-265``):

* ``detect_clipping(audio)``: runs of samples pinned at either rail;
* ``estimate_quality(audio, sr)``: reference-free STOI, SI-SDR and PESQ
  proxy against a spectrally subtracted copy of the audio.

NumPy only, on the host."""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# SI-SDR
# ---------------------------------------------------------------------------


def si_sdr(estimate: np.ndarray, reference: np.ndarray) -> float:
    """Scale-invariant SDR in dB of `estimate` against `reference`."""
    est = np.asarray(estimate, np.float64)
    ref = np.asarray(reference, np.float64)
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    ref_energy = np.dot(ref, ref)
    if ref_energy <= 0:
        return float("-inf")
    alpha = np.dot(est, ref) / ref_energy
    target = alpha * ref
    noise = est - target
    num = np.dot(target, target)
    den = np.dot(noise, noise)
    if den <= 1e-30 * num:
        return 100.0  # numerically perfect reconstruction cap
    return float(10.0 * np.log10(num / den))


# ---------------------------------------------------------------------------
# STOI (Taal et al. 2010)
# ---------------------------------------------------------------------------

_STOI_SR = 10000
_FRAME = 256
_HOP = 128
_NFFT = 512
_N_BANDS = 15
_MIN_FREQ = 150.0
_SEG = 30  # frames per 384 ms segment
_BETA = -15.0  # clipping, dB
_DYN_RANGE = 40.0  # silent-frame removal threshold, dB


def _resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (adequate for band-envelope metrics)."""
    if sr_in == sr_out:
        return x.astype(np.float64)
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(x)), x).astype(np.float64)


def _frames(x: np.ndarray) -> np.ndarray:
    if len(x) < _FRAME:
        # shorter than one frame: no frames (callers' short-input guards
        # handle the empty case); indexing would read past the end
        return np.zeros((0, _FRAME), dtype=np.float64)
    n = 1 + (len(x) - _FRAME) // _HOP
    idx = np.arange(_FRAME)[None, :] + _HOP * np.arange(n)[:, None]
    return x[idx] * np.hanning(_FRAME)[None, :]


def _third_octave_matrix(sr: int) -> np.ndarray:
    """[15, NFFT//2+1] 1/3-octave band indicator matrix."""
    freqs = np.fft.rfftfreq(_NFFT, 1.0 / sr)
    k = np.arange(_N_BANDS, dtype=np.float64)
    cf = _MIN_FREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    mat = (freqs[None, :] >= lo[:, None]) & (freqs[None, :] < hi[:, None])
    return mat.astype(np.float64)


def stoi(clean: np.ndarray, degraded: np.ndarray, sr: int) -> float:
    """Short-time objective intelligibility of `degraded` given `clean`.

    Returns a value in ~[0, 1]; NaN-free for non-degenerate inputs."""
    x = _resample(np.asarray(clean, np.float64), sr, _STOI_SR)
    y = _resample(np.asarray(degraded, np.float64), sr, _STOI_SR)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    xf, yf = _frames(x), _frames(y)
    if len(xf) < _SEG:
        return float("nan")

    # remove frames silent in the clean signal (energy-based VAD)
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy > energy.max() - _DYN_RANGE
    xf, yf = xf[keep], yf[keep]
    if len(xf) < _SEG:
        return float("nan")

    band = _third_octave_matrix(_STOI_SR)
    X = np.sqrt(band @ (np.abs(np.fft.rfft(xf, _NFFT, axis=1).T) ** 2))  # [15, F]
    Y = np.sqrt(band @ (np.abs(np.fft.rfft(yf, _NFFT, axis=1).T) ** 2))

    clip = 10.0 ** (-_BETA / 20.0)
    scores = []
    for m in range(_SEG, X.shape[1] + 1):
        Xs = X[:, m - _SEG: m]  # [15, 30]
        Ys = Y[:, m - _SEG: m]
        # normalize + clip the degraded segment per band
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12
        )
        Yn = np.minimum(Ys * alpha, Xs * (1.0 + clip))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Yn - Yn.mean(axis=1, keepdims=True)
        corr = np.sum(xm * ym, axis=1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
        )
        scores.append(corr.mean())
    return float(np.mean(scores))


def _spectral_subtract(audio: np.ndarray, sr: int) -> np.ndarray:
    """Light spectral-subtraction denoise: noise floor = 10th percentile
    magnitude per bin; over-subtract 1.5x with a 5% magnitude floor."""
    x = np.asarray(audio, np.float64)
    nfft, hop = 512, 128
    win = np.hanning(nfft)
    n = 1 + max(0, (len(x) - nfft) // hop)
    if n < 4:
        return x
    idx = np.arange(nfft)[None, :] + hop * np.arange(n)[:, None]
    S = np.fft.rfft(x[idx] * win[None, :], axis=1)  # [n, F]
    mag, phase = np.abs(S), np.angle(S)
    noise = np.percentile(mag, 10, axis=0, keepdims=True)
    mag_d = np.maximum(mag - 1.5 * noise, 0.05 * mag)
    Sd = mag_d * np.exp(1j * phase)
    frames = np.fft.irfft(Sd, nfft, axis=1) * win[None, :]
    out = np.zeros(len(x))
    norm = np.zeros(len(x))
    for i in range(n):
        sl = slice(i * hop, i * hop + nfft)
        out[sl] += frames[i]
        norm[sl] += win**2
    return out / np.maximum(norm, 1e-8)


def pesq_proxy(clean: np.ndarray, degraded: np.ndarray, sr: int) -> float:
    """PESQ-family MOS estimate (intrusive, P.862-inspired — NOT ITU PESQ).

    Pipeline: level-align both arms, Bark-spaced loudness spectra (power 0.23
    compression as in P.862's loudness mapping), symmetric + asymmetric
    disturbance averages, mapped through a PESQ-shaped logistic to the
    [1.02, 4.56] MOS-LQO range. Useful for *ranking* utterances in data QA
    (the reference's check-data uses SQUIM's neural PESQ the same way,
    fs2/cli/check_data_heavy.py:46-55); not comparable to ITU PESQ scores in
    absolute terms."""
    x = _resample(np.asarray(clean, np.float64), sr, _STOI_SR)
    y = _resample(np.asarray(degraded, np.float64), sr, _STOI_SR)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    # level alignment
    y = y * (np.linalg.norm(x) / (np.linalg.norm(y) + 1e-12))
    xf, yf = _frames(x), _frames(y)
    if len(xf) < 4:
        return float("nan")
    # silent-frame removal on the clean arm
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy > energy.max() - _DYN_RANGE
    xf, yf = xf[keep], yf[keep]
    if len(xf) < 4:
        return float("nan")
    X = np.abs(np.fft.rfft(xf, _NFFT, axis=1)) ** 2  # [F, bins] power
    Y = np.abs(np.fft.rfft(yf, _NFFT, axis=1)) ** 2
    # Bark-spaced triangular-ish bands via the 1/3-octave matrix (denser
    # low-frequency resolution, the property the Bark scale supplies)
    band = _third_octave_matrix(_STOI_SR)
    Xb = X @ band.T + 1e-10  # [F, 15] band powers
    Yb = Y @ band.T + 1e-10
    # loudness compression (Zwicker exponent as used by P.862)
    Lx = Xb ** 0.23
    Ly = Yb ** 0.23
    d = Ly - Lx
    sym = np.sqrt(np.mean(d**2))
    # asymmetric disturbance: additive artifacts (Y >> X) weigh more
    asym_w = np.clip((Yb / Xb) ** 0.3, 1.0, 12.0)
    asym = np.mean(np.abs(d) * asym_w)
    raw = sym + 0.4 * asym
    # logistic map to the PESQ MOS-LQO range
    return float(1.02 + 3.54 / (1.0 + np.exp(2.2 * (raw - 1.2))))


# ---------------------------------------------------------------------------
# Data QA (check-data)
# ---------------------------------------------------------------------------


def detect_clipping(
    audio: np.ndarray, min_run: int = 2, rail_tol: float = 1e-4
) -> tuple[list[tuple[int, int]], int]:
    """Consecutive-sample clipping detector (clipdetect-equivalent; the
    reference's heavy path, fs2/cli/check_data_heavy.py:62-63).

    Digital clipping pins consecutive samples AT the rail, so a clipped
    region is a run of >= `min_run` consecutive samples within
    `rail_tol` x dynamic-range of the recording's extreme (either rail) —
    a smooth waveform passes a rail once per cycle, never dwelling on it.
    Returns (list of [start, end) intervals, total clipped samples) — the
    same (intervals, count) contract as clipdetect.detect_clipping."""
    x = np.asarray(audio, np.float64)
    if len(x) == 0:
        return [], 0
    hi, lo = x.max(), x.min()
    if hi - lo < 1e-6:
        # degenerate dynamic range (digital silence / DC): there are no
        # rails to pin to — without this, tol collapses and every sample
        # of a silent file is reported as clipped
        return [], 0
    tol = rail_tol * (hi - lo)
    pinned = (x >= hi - tol) | (x <= lo + tol)
    # run-length scan over the pinned mask
    idx = np.flatnonzero(pinned)
    if len(idx) == 0:
        return [], 0
    breaks = np.flatnonzero(np.diff(idx) > 1)
    run_starts = np.concatenate([[0], breaks + 1])
    run_ends = np.concatenate([breaks, [len(idx) - 1]])
    intervals = []
    total = 0
    for s, e in zip(run_starts, run_ends):
        length = int(e - s + 1)
        if length >= min_run:
            intervals.append((int(idx[s]), int(idx[e]) + 1))
            total += length
    return intervals, total


def estimate_quality(audio: np.ndarray, sr: int) -> dict:
    """Reference-free quality estimates for data QA.

    The denoised signal acts as the clean arm: `stoi` is the intelligibility
    of the raw audio against it, `si_sdr` the raw audio's SI-SDR against it
    (an SNR proxy), and `pesq` is the PESQ-family proxy MOS of the raw audio
    against it (see pesq_proxy: ranking-grade, not ITU-comparable; install
    torchaudio for SQUIM's neural estimates)."""
    clean = _spectral_subtract(audio, sr)
    return {
        "stoi": stoi(clean, audio, sr),
        "si_sdr": si_sdr(np.asarray(audio, np.float64), clean),
        "pesq": pesq_proxy(clean, audio, sr),
    }
