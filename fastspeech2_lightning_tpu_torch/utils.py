"""File-name helpers (copies of the JAX package's ``utils.slugify`` and
``utils.truncate_basename``). Synthesis output files are named from them,
so they stay byte-equal to the originals."""

from __future__ import annotations

import hashlib
import re


def slugify(text: str, repl: str = "-", limit_to_n_characters: int | None = None) -> str:
    """Filesystem-safe slug of arbitrary text."""
    slug = re.sub(r"[^\w\s\-.]", "", text, flags=re.UNICODE)
    slug = re.sub(r"[\s]+", repl, slug.strip())
    if limit_to_n_characters is not None:
        slug = slug[:limit_to_n_characters]
    return slug


def truncate_basename(basename: str, max_len: int = 20) -> str:
    """Truncate long basenames to max_len chars + sha1 suffix so output
    filenames stay unique but bounded."""
    basename = slugify(basename)
    if len(basename) <= max_len:
        return basename
    digest = hashlib.sha1(basename.encode("utf8")).hexdigest()[:8]
    return f"{basename[:max_len]}-{digest}"
