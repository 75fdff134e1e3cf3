"""Audio in and out, and the text side of preprocessing (copies of the JAX
package's ``preprocessing/pipeline.py`` ``load_wav``, ``save_wav`` and
``Preprocessor.process_text`` with its g2p engine lookup, ``artifact_path``
and ``spec_filename``; the corpus preprocessor itself is not ported yet)."""

from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np

from ..config import CHARACTERS
from ..dataset import SEP
from ..text import TextProcessor
from ..text.features import get_features_for_tokens


def load_wav(path: Path, target_sr: int) -> np.ndarray:
    """A wav file as float32 mono in [-1, 1], resampled to `target_sr`."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        audio = resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
    return audio


def save_wav(path: Path, audio: np.ndarray, sr: int) -> None:
    """PCM16 mono wav: samples clipped to [-1, 1] and scaled by 32767."""
    from scipy.io import wavfile

    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))


class Preprocessor:
    """The text half of the JAX package's ``Preprocessor``: a filelist item
    to its character tokens, phone tokens and phonological features, and
    the names of an utterance's artifacts."""

    def __init__(self, config):
        self.config = config
        self.audio_cfg = config.preprocessing.audio
        self.save_dir = Path(config.preprocessing.save_dir)
        self.text_processor = TextProcessor(config.text)
        self._g2p_cache: dict = {}

    def artifact_path(self, kind: str, basename: str, speaker: str, language: str,
                      fn: str) -> Path:
        """``<save_dir>/<kind>/<basename>--<speaker>--<language>--<fn>``
        (``pipeline.py:109-110``)."""
        return self.save_dir / kind / SEP.join([basename, speaker, language, fn])

    def spec_filename(self) -> str:
        a = self.audio_cfg
        return f"spec-{a.input_sampling_rate}-{a.spec_type}.npy"

    def process_text(self, item: dict, use_pfs: bool = False):
        """(character_tokens, phone_tokens, pfs) for a filelist item
        (``pipeline.py:118-151``). Phones come from a 'phones' column, else
        an 'arpabet' column (through the ARPABET to IPA table), else the
        language's g2p engine; `use_pfs` featurizes the phone tokens (the
        character tokens when there are none)."""
        text = item.get("characters") or item.get("text") or ""
        character_tokens = self.text_processor.process_text(text)
        phone_tokens = None
        phones = None
        if item.get("phones"):
            phone_tokens = self.text_processor.process_text(item["phones"])
        elif item.get("arpabet"):
            from ..text.g2p import arpabet_to_ipa

            phones = arpabet_to_ipa(item["arpabet"])
        else:
            engine = self._g2p_engine(item.get("language") or "default")
            if engine is not None:
                phones = engine(text)
        if phones is not None:
            if isinstance(phones, (list, tuple)):
                phone_tokens = [p for p in phones if p in self.text_processor.symbol_to_id]
            else:
                phone_tokens = self.text_processor.process_text(str(phones))
        pfs = get_features_for_tokens(phone_tokens or character_tokens) if use_pfs else None
        return character_tokens, phone_tokens, pfs

    def _g2p_engine(self, language: str):
        """The g2p callable of `language`, cached: the config's
        ``text.g2p_engines`` entry (a bundled engine's name or the dotted
        path of a callable) for the language or "default" wins; else, for a
        phone-level or phonological-feature model, the bundled engine of the
        language; else None (``pipeline.py:153-190``)."""
        if language in self._g2p_cache:
            return self._g2p_cache[language]
        from ..text.g2p import BUNDLED_ENGINES, get_g2p_engine

        engines = self.config.text.g2p_engines
        dotted = engines.get(language) or engines.get("default")
        engine = None
        if dotted and str(dotted) in BUNDLED_ENGINES:
            engine = BUNDLED_ENGINES[str(dotted)]
        elif dotted:
            module_name, _, attr = str(dotted).rpartition(".")
            try:
                engine = getattr(importlib.import_module(module_name), attr)
            except Exception as e:
                raise ValueError(
                    f"Could not load g2p engine '{dotted}' for language '{language}': {e}"
                ) from e
        elif self.config.model.target_text_representation_level != CHARACTERS:
            engine = get_g2p_engine(language)
        self._g2p_cache[language] = engine
        return engine
