"""Lightning ``.ckpt`` files in the reference layout, as ``fs2t
export-checkpoint`` writes them (the JAX package's
``models/torch_export.py:246-289``): ``hyper_parameters{config, stats,
lang2id, speaker2id}``, ``state_dict``, ``model_info`` and ``global_step``.

Orbax ``step=N/`` directories cannot be read without JAX: convert them with
``fs2t export-checkpoint`` first."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .config import FastSpeech2Config
from .device import resolve_device
from .models.fastspeech2 import FastSpeech2
from .type_definitions import Stats

MODEL_INFO = {"name": "FastSpeech2", "version": "1.2"}


def write_checkpoint(
    path: Union[str, Path],
    state_dict: dict,
    config: dict,
    stats: Optional[dict],
    lang2id: Optional[dict] = None,
    speaker2id: Optional[dict] = None,
    global_step: int = 0,
) -> Path:
    """Save a reference-layout ``.ckpt``; `config` and `stats` are the JSON
    dicts a checkpoint stores."""
    ckpt = {
        "state_dict": {
            k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
            else v
            for k, v in state_dict.items()
        },
        "hyper_parameters": {
            "config": config,
            "stats": stats,
            "lang2id": lang2id or {},
            "speaker2id": speaker2id or {},
        },
        "model_info": dict(MODEL_INFO),
        "global_step": int(global_step),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(ckpt, path)
    return path


def load_model_from_checkpoint(path: Union[str, Path], device=None):
    """(model on `device` in eval mode, config, stats, lang2id, speaker2id,
    global_step) from a reference-layout ``.ckpt``; the state_dict loads
    strictly."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?); the PyTorch port reads "
            "Lightning .ckpt files: convert it with `fs2t export-checkpoint`"
        )
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    info = ckpt.get("model_info", MODEL_INFO)
    if info.get("name", MODEL_INFO["name"]) != MODEL_INFO["name"]:
        raise TypeError(f"wrong model type {info.get('name')!r}; expected FastSpeech2")
    hp = ckpt["hyper_parameters"]
    config = FastSpeech2Config.from_dict(hp["config"])
    if not hp.get("stats"):
        raise ValueError(
            f"{path} carries no corpus stats; the variance adaptor cannot run without them"
        )
    stats = Stats.from_dict(hp["stats"])
    lang2id = dict(hp.get("lang2id") or {})
    speaker2id = dict(hp.get("speaker2id") or {})
    sd = ckpt["state_dict"]
    model = FastSpeech2(
        config,
        n_symbols=sd["text_input_layer.weight"].shape[0],
        n_speakers=(sd["speaker_embedding.weight"].shape[0]
                    if "speaker_embedding.weight" in sd else 1),
        n_languages=(sd["language_embedding.weight"].shape[0]
                     if "language_embedding.weight" in sd else 1),
    )
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    return model, config, stats, lang2id, speaker2id, int(ckpt.get("global_step", 0))
