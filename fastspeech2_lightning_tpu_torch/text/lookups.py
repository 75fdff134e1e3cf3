"""Filelists and the speaker/language lookup tables derived from them
(counterpart of the JAX package's ``text/lookups.py``; the filelist reader
is ``utils.load_filelist``)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..utils import load_filelist

LookupTable = Dict[str, int]

__all__ = ["LookupTable", "build_lookup", "load_filelist", "lookuptables_from_config"]


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
