"""Synthesis data preparation: text chunking and encoding.

A copy of what the serving path needs of the JAX package's
``synthesis/prepare.py`` (``get_text_split_params``,
``representation_for_model``, ``chunk_text_for_model`` and the character
branch of ``encode_texts_for_model``)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import CHARACTERS, PHONES
from ..text.textsplit import chunk_text


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


def encode_texts_for_model(texts: List[str], config, text_processor) -> List[np.ndarray]:
    """Per-text int32 symbol ids. Only character-level models are served by
    this port so far: phone-level and phonological-feature models need the
    g2p and preprocessing modules, which come with a later slice."""
    level = config.model.target_text_representation_level
    if level != CHARACTERS:
        raise NotImplementedError(
            f"{level!r}-level models need g2p and the preprocessing pipeline, "
            "which are not ported yet (later slice: phones/pfs input); "
            "serve them with the JAX package"
        )
    return [np.asarray(text_processor.encode_text(t), dtype=np.int32) for t in texts]
