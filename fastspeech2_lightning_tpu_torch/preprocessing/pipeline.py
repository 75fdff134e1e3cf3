"""Audio output (a copy of the JAX package's ``preprocessing/pipeline.py``
``save_wav``; the corpus preprocessor is not ported yet)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_wav(path: Path, audio: np.ndarray, sr: int) -> None:
    """PCM16 mono wav: samples clipped to [-1, 1] and scaled by 32767."""
    from scipy.io import wavfile

    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))
