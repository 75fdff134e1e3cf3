"""Convert a reference preprocessed tree (``.pt`` artifacts) to ``.npy``
(a copy of the JAX package's ``preprocessing/convert.py``).

The reference's preprocessor writes every per-utterance artifact as a torch
tensor in a ``.pt`` file under ``save_dir/{audio,spec,attn,text,pitch,energy,
duration,pfs}``, named ``{basename}--{speaker}--{language}--{artifact}.pt``.
This package reads the same tree with ``.npy`` payloads. Each ``.pt`` gets
an ``.npy`` sibling, written to a temporary name and renamed into place;
``stats.json`` and the filelists are plain JSON and PSV already."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

ARTIFACT_DIRS = ("audio", "spec", "attn", "text", "pitch", "energy", "duration", "pfs")


def _to_numpy(obj) -> Optional[np.ndarray]:
    """The array a ``torch.load`` payload holds, or None."""
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (int, float)):
        return np.asarray(obj)
    if isinstance(obj, (list, tuple)) and obj:
        try:
            return np.asarray(obj)
        except ValueError:  # ragged nesting
            return None
    return None


def convert_artifact_tree(root: Path, overwrite: bool = False,
                          log: Callable[[str], None] = lambda s: None,
                          dirs: Iterable[str] = ARTIFACT_DIRS) -> tuple:
    """Convert every ``.pt`` under ``root/<artifact dir>`` to an ``.npy``
    sibling; returns (converted, skipped). Skipped are files whose ``.npy``
    exists (unless `overwrite`) and payloads that hold no array."""
    converted = skipped = 0
    for sub in dirs:
        d = Path(root) / sub
        if not d.is_dir():
            continue
        for pt in sorted(d.rglob("*.pt")):
            out = pt.with_suffix(".npy")
            if out.exists() and not overwrite:
                skipped += 1
                continue
            try:
                payload = torch.load(pt, map_location="cpu", weights_only=True)
            except pickle.UnpicklingError:
                # older pickles of the reference's own tree (saved dataclasses
                # and the like), as the JAX package reads them
                payload = torch.load(pt, map_location="cpu", weights_only=False)
            arr = _to_numpy(payload)
            if arr is None or arr.dtype == object:
                log(f"skipping non-tensor payload: {pt}")
                skipped += 1
                continue
            tmp = out.with_name(out.name + ".tmp")
            np.save(tmp, np.ascontiguousarray(arr), allow_pickle=False)
            tmp_real = tmp if tmp.exists() else tmp.with_name(tmp.name + ".npy")
            tmp_real.replace(out)
            converted += 1
            log(f"{pt.name} -> {out.name}  {arr.shape} {arr.dtype}")
    return converted, skipped
