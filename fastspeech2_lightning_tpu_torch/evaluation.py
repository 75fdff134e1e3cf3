"""Copy-synthesis evaluation of a vocoder (counterpart of the JAX package's
``evaluation.py``): vocode the ground-truth mels of the validation filelist
and score each waveform against the real audio with the objective metrics
of ``preprocessing/objective.py`` (SI-SDR, STOI, the PESQ-shaped proxy),
plus the mel L1 between the re-extracted log-mel of the generated audio and
the input mel."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def evaluate_vocoder(config, vocoder_path: Path, n_utterances: int = 16,
                     precision: str = "float32", filelist: Optional[Path] = None,
                     device=None) -> dict:
    """-> {"n": N, "mel_l1", "si_sdr_db", "stoi", "pesq_proxy"}: means over
    the first N rows of the validation filelist (or `filelist`) that have
    both their audio and spec artifacts; rows without them are skipped. The
    vocoder runs on `device` (the card unless "cpu")."""
    from .device import resolve_device
    from .models.hifigan import load_vocoder_checkpoint
    from .preprocessing.features import mel_spectrogram_numpy
    from .preprocessing.objective import pesq_proxy, si_sdr, stoi
    from .preprocessing.pipeline import Preprocessor, load_wav
    from .text.lookups import load_filelist

    device = resolve_device(device)
    a = config.preprocessing.audio
    vocoder, _step, _hop = load_vocoder_checkpoint(Path(vocoder_path), precision=precision,
                                                   device=device)
    pre = Preprocessor(config)
    rows = load_filelist(Path(filelist or config.training.validation_filelist))

    per_utt = {"mel_l1": [], "si_sdr_db": [], "stoi": [], "pesq_proxy": []}
    used = 0
    for r in rows:
        if used >= n_utterances:
            break
        b = r["basename"]
        s = r.get("speaker") or "default"
        lang = r.get("language") or "default"
        wav_p = pre.artifact_path("audio", b, s, lang, f"audio-{a.input_sampling_rate}.wav")
        spec_p = pre.artifact_path("spec", b, s, lang, pre.spec_filename())
        if not (wav_p.exists() and spec_p.exists()):
            continue
        mel = np.load(spec_p)  # [n_mels, T]
        real = load_wav(wav_p, a.input_sampling_rate)
        gen, _sr = vocoder(mel.T[None].astype(np.float32))
        gen = np.asarray(gen, dtype=np.float32)[0]
        n = min(len(gen), len(real))
        gen, real = gen[:n], real[:n]
        remel = mel_spectrogram_numpy(gen, a.input_sampling_rate, a.n_fft, a.fft_hop_size,
                                      a.fft_window_size, a.n_mels, a.f_min, a.f_max,
                                      a.spec_type)
        t = min(remel.shape[1], mel.shape[1])
        per_utt["mel_l1"].append(float(np.abs(remel[:, :t] - mel[:, :t]).mean()))
        per_utt["si_sdr_db"].append(si_sdr(gen, real))
        per_utt["stoi"].append(stoi(real, gen, a.input_sampling_rate))
        per_utt["pesq_proxy"].append(pesq_proxy(real, gen, a.input_sampling_rate))
        used += 1
    if not used:
        raise FileNotFoundError("no validation utterances with (audio, spec) artifacts found")
    return {"n": used, **{k: float(np.mean(v)) for k, v in per_utt.items()}}
