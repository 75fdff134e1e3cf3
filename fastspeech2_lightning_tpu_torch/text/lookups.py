"""Filelists and the speaker/language lookup tables derived from them
(counterpart of the JAX package's ``text/lookups.py`` and
``utils.load_filelist``)."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Tuple, Union

LookupTable = Dict[str, int]

_DELIMITERS = {".psv": "|", ".csv": ",", ".tsv": "\t"}


def load_filelist(path: Union[str, Path]) -> List[dict]:
    """Rows of a delimited filelist with a header row (``.psv``, ``.csv``,
    ``.tsv``), or one ``{"basename", "text"}`` per line of a plain file."""
    path = Path(path)
    if path.suffix in _DELIMITERS:
        with open(path, "r", encoding="utf8", newline="") as f:
            return [dict(row) for row in csv.DictReader(f, delimiter=_DELIMITERS[path.suffix])]
    with open(path, "r", encoding="utf8") as f:
        lines = [line.rstrip("\n") for line in f]
    return [{"basename": f"line-{i}", "text": line} for i, line in enumerate(lines) if line]


def build_lookup(items: List[dict], key: str) -> LookupTable:
    """value -> id over a filelist column, sorted; missing or empty values
    are "default", as the dataset resolves them."""
    values = sorted({(item.get(key) or "default") for item in items})
    return {v: i for i, v in enumerate(values)}


def lookuptables_from_config(config) -> Tuple[LookupTable, LookupTable]:
    """(lang2id, speaker2id) over the training and validation filelists."""
    items = (load_filelist(config.training.training_filelist)
             + load_filelist(config.training.validation_filelist))
    return build_lookup(items, "language"), build_lookup(items, "speaker")
