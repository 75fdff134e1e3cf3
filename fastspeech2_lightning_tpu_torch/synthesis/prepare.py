"""Synthesis data preparation: text chunking, language and speaker
validation, and encoding.

A copy of the JAX package's ``synthesis/prepare.py``:
``validate_data_keys_with_model_keys``, ``get_text_split_params``,
``representation_for_model``, ``chunk_text_for_model``,
``encode_texts_for_model`` and ``prepare_data`` (with the style reference's
log-mel on every item)."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import CHARACTERS, PHONES, PHONOLOGICAL_FEATURES
from ..text.lookups import load_filelist
from ..text.textsplit import chunk_text
from ..utils import slugify, truncate_basename


def validate_data_keys_with_model_keys(
    data_keys: set, model_keys: set, key: str, multi: bool
) -> None:
    """Raise ValueError when the items name a language or speaker the model
    lacks (or name any on a model that has one)."""
    if multi:
        if None in data_keys:
            raise ValueError(
                f"You have not specified a {key} for all your sentences."
                f" Available values are {model_keys}"
            )
        extras = data_keys.difference(model_keys)
        if extras:
            raise ValueError(
                f"You provided {data_keys} which are not {key}s supported by "
                f"the model {model_keys or {}}."
            )
    else:
        extras = data_keys.difference(model_keys | {None})
        if extras:
            raise ValueError(
                f"The current model doesn't support multiple {key}s but your "
                f"data has {key}s {extras}. Please retrain your model with "
                f"multi{'lingual' if key == 'language' else key} set to True."
            )


def get_text_split_params(
    stats,
    text_representation: str,
    config=None,
    language: Optional[str] = None,
) -> tuple[int, int, str, str]:
    """(desired_length, max_length, strong, weak) from corpus stats and the
    text config's per-language boundaries (fs2/cli/synthesize.py:75-128)."""
    desired, maxi = 100, 200
    try:
        if text_representation == CHARACTERS:
            desired = int(stats.character_length.mean)
            maxi = int(stats.character_length.max)
        elif text_representation == PHONES:
            desired = int(stats.phone_length.mean)
            maxi = int(stats.phone_length.max)
    except AttributeError:
        pass
    strong, weak = ".!?:;", ",-— "
    if config is not None:
        b = config.text.boundaries.get(language or "", None) or config.text.boundaries.get(
            "default", None
        )
        if isinstance(b, dict):
            strong = b.get("strong", strong)
            weak = b.get("weak", weak)
    return desired, maxi, strong, weak


def representation_for_model(config) -> str:
    """The dataset text representation whose corpus length stats match the
    model's trained representation (phone stats for phones/pfs models)."""
    level = config.model.target_text_representation_level
    return CHARACTERS if level == CHARACTERS else PHONES


def chunk_text_for_model(text: str, language: Optional[str], config, stats) -> List[str]:
    """Chunk long input at corpus-informed boundaries, deriving split stats
    from the model's text representation. Returns [text] when chunking is
    disabled or nothing splits."""
    if not config.text.split_text:
        return [text]
    desired, maxi, strong, weak = get_text_split_params(
        stats, representation_for_model(config), config, language
    )
    return chunk_text(text, desired, maxi, strong, weak) or [text]


def encode_texts_for_model(texts: List[str], language: Optional[str], config,
                           text_processor, cache: dict):
    """(ids, pfs) for `texts` at the model's representation level
    (``prepare.py:105-160``): a character model's symbol ids and None; a
    phone-level model's ids of the phones ``Preprocessor.process_text``
    gives for `language`; a phonological-feature model's ids of its phones
    (its characters where g2p gives none), kept to the symbol inventory,
    and their features, one [T, N_PHONOLOGICAL_FEATURES] float32 matrix a
    text whose rows match the ids. `cache` keeps the Preprocessor between
    calls."""
    level = config.model.target_text_representation_level
    if level == CHARACTERS:
        return [np.asarray(text_processor.encode_text(t), dtype=np.int32) for t in texts], None
    use_pfs = level == PHONOLOGICAL_FEATURES
    pre = cache.get("preprocessor")
    if pre is None:
        from ..preprocessing.pipeline import Preprocessor

        pre = cache["preprocessor"] = Preprocessor(config)
    ids, pfs_mats = [], []
    for t in texts:
        char_tokens, phone_tokens, _ = pre.process_text({"text": t,
                                                         "language": language or "default"})
        tokens = (phone_tokens or char_tokens) if use_pfs else phone_tokens
        if use_pfs:
            from ..text.features import get_features_for_tokens

            tokens = [tok for tok in tokens or [] if tok in text_processor.symbol_to_id]
            pfs_mats.append(get_features_for_tokens(tokens))
        ids.append(np.asarray(text_processor.encode_tokens(tokens or []), dtype=np.int32))
    return ids, (pfs_mats if use_pfs else None)


def prepare_data(
    texts: Optional[List[str]],
    language: Optional[str],
    speaker: Optional[str],
    filelist: Optional[Path],
    config,
    stats,
    lang2id: dict,
    speaker2id: dict,
    text_representation: str = CHARACTERS,
    duration_control: float = 1.0,
    style_reference: Optional[Path] = None,
    split_text: Optional[bool] = None,
) -> List[dict]:
    """Synthesis items from `texts` or a filelist: each text chunked at the
    corpus-informed boundaries (unless `split_text` or the config turns that
    off), one item a chunk with ``is_last_input_chunk`` on its last, the
    language and speaker defaulting to the model's first, validated against
    the model, and `duration_control` on every item, with the
    `style_reference` wav's log-mel [T, n_mels] as ``mel_style_reference``
    when one is given."""
    default_language = next(iter(lang2id.keys()), None)
    default_speaker = next(iter(speaker2id.keys()), None)
    if split_text is None:
        split_text = config.text.split_text
    desired, maxi, strong, weak = get_text_split_params(
        stats, text_representation, config, language or default_language
    )

    def make_items(text: str, lang, spk, basename: Optional[str] = None):
        chunks = (
            chunk_text(text, desired, maxi, strong, weak) if split_text else [text]
        )
        out = []
        for i, chunk in enumerate(chunks):
            out.append(
                {
                    "basename": basename or truncate_basename(slugify(chunk)),
                    text_representation: chunk,
                    "text": chunk,
                    "language": lang or default_language,
                    "speaker": spk or default_speaker,
                    "is_last_input_chunk": i == len(chunks) - 1,
                }
            )
        print(f"Processing text: {chunks}", file=sys.stderr)
        return out

    data: List[dict] = []
    if texts:
        for text in texts:
            data.extend(make_items(text, language, speaker))
    else:
        if filelist is None:
            raise ValueError("Filelist must be provided when texts is empty or None")
        for d in load_filelist(filelist):
            line = d.get(text_representation) or d.get("text") or ""
            data.extend(
                make_items(
                    line,
                    language or d.get("language", default_language),
                    speaker or d.get("speaker", default_speaker),
                    basename=d.get("basename"),
                )
            )

    validate_data_keys_with_model_keys(
        {d["language"] for d in data}, set(lang2id.keys()), "language",
        config.model.multilingual,
    )
    validate_data_keys_with_model_keys(
        {d["speaker"] for d in data}, set(speaker2id.keys()), "speaker",
        config.model.multispeaker,
    )
    ref = None
    if style_reference is not None:
        ref = style_reference_mel(Path(style_reference), config.preprocessing.audio)
    for item in data:
        item["duration_control"] = duration_control
        if ref is not None:
            item["mel_style_reference"] = ref
    return data


def style_reference_mel(path: Path, audio_config) -> np.ndarray:
    """[T, n_mels] float32 log-mel of a style-reference wav, resampled to
    the input rate (``prepare.py:237-249``)."""
    from ..preprocessing.features import mel_spectrogram_numpy
    from ..preprocessing.pipeline import load_wav

    a = audio_config
    audio = load_wav(Path(path), a.input_sampling_rate)
    return mel_spectrogram_numpy(audio, a.input_sampling_rate, a.n_fft, a.fft_hop_size,
                                 a.fft_window_size, a.n_mels, a.f_min, a.f_max,
                                 a.spec_type).T.astype(np.float32)
