"""The acoustic model's seeded weights and batches, made by the benchmark and
handed alike to the program and to the reference."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..reference.fastspeech2 import Model, param_spec
from ..reference.numerics import Numerics, strict_float32
from . import corpus, weights


def weight_rules(cfg: dict) -> Dict[str, tuple]:
    """{name: (shape, rule)} of every parameter: fan-in scaled normals for
    products, N(0, 1/d) text embeddings, pitch and energy tables that vary
    smoothly from bin to bin (so a value near a bin edge that rounds either
    way moves the output a little, as in a trained model), norm scales near
    1, small biases, and a duration head at 0.3/sqrt(d), whose symbols'
    durations spread as a trained head's do (a log-duration's deviation
    about 0.15). Its bias is set by ``calibrate_duration``."""
    rules = {}
    for name, shape in param_spec(cfg, corpus.n_symbols()).items():
        if name.endswith("duration_predictor.linear.bias"):
            rule = ("normal", math.log(7.0), 0.0)
        elif name.endswith("duration_predictor.linear.weight"):
            rule = ("normal", 0.0, 0.3 / math.sqrt(shape[1]))
        elif name.endswith(("pitch_embedding.weight", "energy_embedding.weight")):
            rule = ("smooth", shape[1] ** -0.5, 8)  # neighbouring bins alike
        elif "embedding" in name or name == "text_input_layer.weight":
            rule = ("normal", 0.0, shape[1] ** -0.5)
        elif len(shape) == 1:
            norm = name.endswith(".weight")
            rule = ("normal", 1.0 if norm else 0.0, 0.1)
        else:
            rule = weights.fan_in_normal(shape)
        rules[name] = (shape, rule)
    return rules


def buffer_rules(cfg: dict) -> Dict[str, tuple]:
    """The served model's BatchNorm running statistics (about (0, 1))."""
    rules = {}
    m = cfg["model"]
    for part in ("encoder", "decoder"):
        c = m[part]
        for i in range(c["layers"]):
            p = f"{part}.conformer_layers.{i}.conv_module.sequential.3."
            rules[p + "running_mean"] = ((c["input_dim"],), ("normal", 0.0, 0.1))
            rules[p + "running_var"] = ((c["input_dim"],), ("uniform", 0.5, 1.5))
    n_mels = cfg["preprocessing"]["audio"]["n_mels"]
    for i in range(5):
        c = n_mels if i == 4 else 512
        rules[f"postnet.convolutions.{i}.1.running_mean"] = ((c,), ("normal", 0.0, 0.1))
        rules[f"postnet.convolutions.{i}.1.running_var"] = ((c,), ("uniform", 0.5, 1.5))
    return rules


# the parameters and statistics that set a text's predicted durations
DURATION_PATH = ("text_input_layer.", "encoder.", "variance_adaptor.duration_predictor.",
                 "variance_adaptor.pitch_", "variance_adaptor.energy_")


def on_duration_path(name: str) -> bool:
    return name.startswith(DURATION_PATH)


def calibrate_duration(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                       cfg: dict, device) -> None:
    """Shifts the duration head's bias so that the plain reference's mean
    log-duration over a fixed set of texts is log 7 (about 6 frames a
    symbol, as LJSpeech's characters take at hop 256), whatever the draw of
    the weights before it would give (4.4 to 8.0 frames a symbol over three
    draws)."""
    rng = corpus.size_rng("calibration")
    texts = [corpus.text_of_length(rng, int(n)) for n in rng.integers(20, 191, 64)]
    ids = [corpus.encode(t) for t in texts]
    L = round_up(max(map(len, ids)), 16)
    text = torch.zeros(len(ids), L, dtype=torch.long, device=device)
    for i, e in enumerate(ids):
        text[i, :len(e)] = torch.as_tensor(e)
    src = torch.as_tensor([len(e) for e in ids], device=device)
    mask = torch.arange(L, device=device)[None] < src[:, None]
    with strict_float32(), torch.no_grad():
        model = Model(params, cfg, Numerics("float32"), buffers)
        logdur = model.forward_inference(text, src, torch.zeros_like(text), 16,
                                         variance_bins(cfg, device))["duration_prediction"]
        bias = next(k for k in params if k.endswith("duration_predictor.linear.bias"))
        params[bias] += math.log(7.0) - logdur[mask].mean()


def variance_bins(cfg: dict, device) -> Dict[str, torch.Tensor]:
    vp = cfg["model"]["variance_predictors"]
    return {k: torch.as_tensor(corpus.bins(vp[k]["n_bins"], k), device=device)
            for k in ("pitch", "energy")}


def round_up(n: int, mult: int) -> int:
    return max(mult, -(-n // mult) * mult)


def collate(root: Path, basenames: List[str], texts: Dict[str, str], weight: np.ndarray,
            L: int, T: int, spec_name: str, device) -> Dict[str, torch.Tensor]:
    """A training batch from the corpus's raw files, padded to [L, T]: the
    reference's own collation."""
    B = len(basenames)
    n_mels = None
    text = np.zeros((B, L), np.int64)
    src, mel_lens = np.zeros(B, np.int64), np.zeros(B, np.int64)
    arrays = [corpus.read_utterance(root, b, spec_name) for b in basenames]
    n_mels = arrays[0]["mel"].shape[1]
    mel = np.zeros((B, T, n_mels), np.float32)
    pitch, energy = np.zeros((B, T), np.float32), np.zeros((B, T), np.float32)
    prior = np.zeros((B, T, L), np.float32)
    for i, (b, u) in enumerate(zip(basenames, arrays)):
        ids = corpus.encode(texts[b])[:L]
        src[i] = len(ids)
        text[i, :len(ids)] = ids
        n = min(u["mel"].shape[0], T)
        mel_lens[i] = n
        mel[i, :n] = u["mel"][:n]
        pitch[i, :n], energy[i, :n] = u["pitch"][:n], u["energy"][:n]
        p = u["attn_prior"]
        prior[i, :min(p.shape[0], T), :min(p.shape[1], L)] = p[:T, :L]
    out = dict(text=text, src_lens=src, mel_lens=mel_lens, mel=mel, pitch=pitch,
               energy=energy, attn_prior=prior, sample_weight=weight.astype(np.float32))
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}
