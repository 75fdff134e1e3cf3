"""File-name and filelist helpers (copies of the JAX package's
``utils.slugify``, ``truncate_basename``, ``generic_psv_filelist_reader``,
``plain_text_filelist_reader``, ``load_filelist`` and ``write_filelist``,
``utils/__init__.py:14-75``). Synthesis output files are named from them and
preprocessing writes its filelists with them, so both stay byte-equal to the
originals."""

from __future__ import annotations

import csv
import hashlib
import re
from pathlib import Path
from typing import List, Union


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


def generic_psv_filelist_reader(path: Union[str, Path], delimiter: str = "|") -> List[dict]:
    """Rows of a delimited filelist with a header row."""
    with open(path, "r", encoding="utf8", newline="") as f:
        return [dict(row) for row in csv.DictReader(f, delimiter=delimiter)]


def plain_text_filelist_reader(path: Union[str, Path]) -> List[dict]:
    """One ``{"basename": "line-<i>", "text": line}`` per non-empty line."""
    with open(path, "r", encoding="utf8") as f:
        lines = [line.rstrip("\n") for line in f]
    return [{"basename": f"line-{i}", "text": line} for i, line in enumerate(lines) if line]


_DELIMITERS = {".psv": "|", ".csv": ",", ".tsv": "\t"}


def load_filelist(path: Union[str, Path]) -> List[dict]:
    """A ``.psv``, ``.csv`` or ``.tsv`` filelist with a header row, or a
    plain file of one text a line."""
    path = Path(path)
    if path.suffix in _DELIMITERS:
        return generic_psv_filelist_reader(path, delimiter=_DELIMITERS[path.suffix])
    return plain_text_filelist_reader(path)


def write_filelist(items: List[dict], path: Union[str, Path], delimiter: str = "|") -> None:
    """`items` under a header of every key in first-seen order (an empty
    file for no items)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not items:
        path.write_text("")
        return
    fieldnames: List[str] = []
    for item in items:
        for k in item:
            if k not in fieldnames:
                fieldnames.append(k)
    with open(path, "w", encoding="utf8", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, delimiter=delimiter)
        writer.writeheader()
        writer.writerows(items)
