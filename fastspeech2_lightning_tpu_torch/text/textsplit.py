"""Long-text chunking: a copy of the JAX package's ``text/textsplit.py``
(re-provides everyvoice.text.textsplit.chunk_text).

Splits text at strong/weak boundary punctuation into chunks whose desired/max
token counts come from corpus length stats (used at fs2/cli/synthesize.py:75-128;
chunks are synthesized independently and reassembled by the writers)."""

from __future__ import annotations

import re
from typing import List

DEFAULT_STRONG_BOUNDARIES = ".!?:;"
DEFAULT_WEAK_BOUNDARIES = ",-— "


def _split_keep(text: str, boundaries: str) -> List[str]:
    """Split text after any boundary char, keeping the boundary attached."""
    if not boundaries:
        return [text]
    pattern = "([" + re.escape(boundaries) + "]+)"
    parts = re.split(pattern, text)
    out: List[str] = []
    for i in range(0, len(parts), 2):
        seg = parts[i]
        if i + 1 < len(parts):
            seg += parts[i + 1]
        if seg:
            out.append(seg)
    return out


def chunk_text(
    text: str,
    desired_length: int = 100,
    max_length: int = 200,
    strong_boundaries: str = DEFAULT_STRONG_BOUNDARIES,
    weak_boundaries: str = DEFAULT_WEAK_BOUNDARIES,
) -> List[str]:
    """Greedy chunker: accumulate strong-boundary segments up to
    desired_length; segments longer than max_length are re-split at weak
    boundaries; a segment with no boundary at all is hard-wrapped."""
    if len(text) <= max_length:
        stripped = text.strip()
        return [stripped] if stripped else []

    segments: List[str] = []
    for strong_seg in _split_keep(text, strong_boundaries):
        if len(strong_seg) <= max_length:
            segments.append(strong_seg)
            continue
        for weak_seg in _split_keep(strong_seg, weak_boundaries):
            if len(weak_seg) <= max_length:
                segments.append(weak_seg)
            else:
                for start in range(0, len(weak_seg), max_length):
                    segments.append(weak_seg[start : start + max_length])

    chunks: List[str] = []
    current = ""
    for seg in segments:
        if current and len(current) + len(seg) > desired_length:
            chunks.append(current)
            current = seg
        else:
            current += seg
    if current:
        chunks.append(current)
    return [c.strip() for c in chunks if c.strip()]
