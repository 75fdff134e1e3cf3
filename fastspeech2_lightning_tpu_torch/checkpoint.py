"""Lightning ``.ckpt`` files in the reference layout, as ``fs2t
export-checkpoint`` writes them (the JAX package's
``models/torch_export.py:246-289``): ``hyper_parameters{config, stats,
lang2id, speaker2id}``, ``state_dict``, ``model_info`` and ``global_step``.

Every load passes the version gate (``check_and_upgrade_checkpoint``, a copy
of the JAX package's ``training/checkpoint.py:264-321``). A trainer's
``step=N/`` directory holds such a file as ``model.ckpt``, and its EMA
weights in ``train_state.pt``. Orbax ``step=N/`` directories cannot be read
without JAX: convert them with ``fs2t export-checkpoint`` first."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .config import FastSpeech2Config
from .device import resolve_device
from .models.fastspeech2 import FastSpeech2
from .text import TextProcessor
from .text.processor import get_symbols_from_symbol_dict, symbol_sorter
from .type_definitions import Stats

MODEL_NAME = "FastSpeech2"
MODEL_VERSION = "1.2"
MODEL_INFO = {"name": MODEL_NAME, "version": MODEL_VERSION}
EMBEDDING = "text_input_layer.weight"


class CheckpointError(Exception):
    pass


def parse_version(text: str) -> Tuple[int, ...]:
    """"1.2" -> (1, 2); trailing zeros dropped, so "1.2.0" equals "1.2"."""
    parts = [int(p) for p in str(text).split(".")]
    while parts and parts[-1] == 0:
        parts.pop()
    return tuple(parts)


def check_and_upgrade_checkpoint(meta: dict, state_dict: dict,
                                 current_symbols: List[str]) -> Tuple[dict, dict]:
    """Version gate and migrations: a wrong model name raises TypeError, a
    newer version ValueError, phonological-feature models before 1.2
    ValueError; a missing ``model_info`` counts as 1.0, and a character
    model before 1.2 has its text-embedding rows moved to where
    `current_symbols` puts each of ``meta["symbols"]``."""
    model_info = meta.get("model_info", {"name": MODEL_NAME, "version": "1.0"})
    meta["model_info"] = model_info
    name = model_info.get("name", "MISSING_TYPE")
    if name != MODEL_NAME:
        raise TypeError(f"Wrong model type ({name}), we are expecting a '{MODEL_NAME}' model")
    text_version = model_info.get("version", "0.0")
    version = parse_version(text_version)
    if version > parse_version(MODEL_VERSION):
        raise ValueError(
            "Your model was created with a newer version of this software, please update."
        )
    if version < parse_version("1.0"):
        meta["model_info"]["version"] = "1.0"
    level = (meta.get("config", {}).get("model", {})
             .get("target_text_representation_level", "characters"))
    if version < parse_version("1.2") and level == "phonological_features":
        raise ValueError(
            f"Breaking changes to phonological-feature handling in model version 1.2; "
            f"your model is version {text_version}. Please re-train."
        )
    elif version < parse_version("1.2"):
        ckpt_symbols = meta.get("symbols", [])
        if len(ckpt_symbols) > len(current_symbols):
            raise CheckpointError(
                "Unable to automatically update your embedding table: the checkpoint has "
                "more symbols than the current model."
            )
        missing = [s for s in ckpt_symbols if s not in current_symbols]
        if missing:
            raise CheckpointError(
                "Unable to automatically update your embedding table: checkpoint symbols "
                f"{missing!r} are not in the current model's symbol inventory."
            )
        old = torch.as_tensor(state_dict[EMBEDDING])
        new = torch.zeros((len(current_symbols), old.shape[1]), dtype=old.dtype)
        index = {s: j for j, s in enumerate(current_symbols)}
        for i, sym in enumerate(ckpt_symbols):
            new[index[sym]] = old[i]
        state_dict[EMBEDDING] = new
        meta["model_info"]["version"] = MODEL_VERSION
    return meta, state_dict


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


def read_checkpoint(path: Union[str, Path], current_symbols: Optional[List[str]] = None):
    """(ckpt dict, FastSpeech2Config) of a reference-layout ``.ckpt``, its
    state_dict through the version gate. The checkpoint's symbols are its
    config's; `current_symbols` (default: the same) is the inventory of the
    model that will load it."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    hp = ckpt["hyper_parameters"]
    config = FastSpeech2Config.from_dict(hp["config"])
    ckpt_symbols = symbol_sorter(get_symbols_from_symbol_dict(
        (hp["config"].get("text") or {}).get("symbols") or {}))
    meta = {"model_info": ckpt.get("model_info") or {"name": MODEL_NAME, "version": "1.0"},
            "config": hp["config"], "symbols": ckpt_symbols}
    if current_symbols is None:
        current_symbols = TextProcessor(config.text).symbols
    meta, ckpt["state_dict"] = check_and_upgrade_checkpoint(meta, ckpt["state_dict"],
                                                            current_symbols)
    ckpt["model_info"] = meta["model_info"]
    return ckpt, config


def load_model_from_checkpoint(path: Union[str, Path], device=None, use_ema: bool = False):
    """(model on `device` in eval mode, config, stats, lang2id, speaker2id,
    global_step) from a reference-layout ``.ckpt`` or a trainer's
    ``step=N/`` directory; the state_dict loads strictly. `use_ema` takes
    the EMA weights a ``step=N/`` directory holds."""
    path = Path(path)
    ema = None
    if path.is_dir():
        if not (path / "model.ckpt").is_file():
            raise ValueError(
                f"{path} is a directory without model.ckpt (an orbax checkpoint?); the "
                "PyTorch port reads Lightning .ckpt files and its own step=N/ "
                "directories: convert it with `fs2t export-checkpoint`"
            )
        if use_ema:
            ema = torch.load(path / "train_state.pt", map_location="cpu",
                             weights_only=True).get("ema")
            if ema is None:
                raise ValueError(f"{path} holds no EMA weights: the model was trained "
                                 "without training.ema_decay; cannot honor --use-ema.")
        path = path / "model.ckpt"
    elif use_ema:
        raise ValueError("--use-ema applies to step=N/ checkpoints trained with "
                         "training.ema_decay; .ckpt files carry no EMA weights.")
    device = resolve_device(device)
    ckpt, config = read_checkpoint(path)
    hp = ckpt["hyper_parameters"]
    if not hp.get("stats"):
        raise ValueError(
            f"{path} carries no corpus stats; the variance adaptor cannot run without them"
        )
    stats = Stats.from_dict(hp["stats"])
    lang2id = dict(hp.get("lang2id") or {})
    speaker2id = dict(hp.get("speaker2id") or {})
    sd = dict(ckpt["state_dict"])
    if ema is not None:
        sd.update(ema)
    model = FastSpeech2(
        config,
        n_symbols=sd[EMBEDDING].shape[0],
        n_speakers=(sd["speaker_embedding.weight"].shape[0]
                    if "speaker_embedding.weight" in sd else 1),
        n_languages=(sd["language_embedding.weight"].shape[0]
                     if "language_embedding.weight" in sd else 1),
    )
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    return model, config, stats, lang2id, speaker2id, int(ckpt.get("global_step", 0))
