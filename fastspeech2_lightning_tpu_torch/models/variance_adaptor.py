"""Variance adaptor, inference branch (counterpart of the JAX package's
``models/variance_adaptor.py:178-228``): pitch/energy predictors with
bucketized embeddings, the duration predictor, rounding of the predicted
durations and the length regulator."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops.length_regulator import length_regulate
from ..ops.variance import bucketize
from .attention import ConvAttention
from .layers import Embedding, VariancePredictor


class VarianceAdaptor(nn.Module):
    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        mcfg = config.model
        vp = mcfg.variance_predictors
        d = mcfg.encoder.input_dim
        self.config = config

        def predictor(c):
            return VariancePredictor(
                d, c.n_layers, c.input_dim, c.kernel_size, c.depthwise, dtype=dtype
            )

        self.duration_predictor = predictor(vp.duration)
        self.pitch_predictor = predictor(vp.pitch)
        self.energy_predictor = predictor(vp.energy)
        self.pitch_embedding = Embedding(vp.pitch.n_bins, vp.pitch.input_dim, dtype=dtype)
        self.energy_embedding = Embedding(vp.energy.n_bins, vp.energy.input_dim, dtype=dtype)
        # bin boundaries come from the checkpoint's buffers (load_state_dict)
        self.register_buffer("pitch_bins", torch.zeros(vp.pitch.n_bins - 1))
        self.register_buffer("energy_bins", torch.zeros(vp.energy.n_bins - 1))
        if mcfg.learn_alignment:
            n_mels = config.preprocessing.audio.n_mels
            self.attention = ConvAttention(n_mels, d, n_mels)

    def _variance(self, x, mask, predictor, embedding, bins, control):
        prediction = predictor(x, mask) * control
        return prediction, embedding(bucketize(prediction, bins))

    def forward(
        self,
        x: torch.Tensor,  # [B, L, D] encoder output (+ speaker/language)
        src_mask: torch.Tensor,  # [B, L] bool
        control: Dict[str, float],
        max_target_len: int,
    ) -> Dict[str, torch.Tensor]:
        vp = self.config.model.variance_predictors
        energy_prediction = pitch_prediction = None
        if vp.energy.level == "phone":
            energy_prediction, emb = self._variance(
                x, src_mask, self.energy_predictor, self.energy_embedding,
                self.energy_bins, control["energy"],
            )
            x = x + emb
        if vp.pitch.level == "phone":
            pitch_prediction, emb = self._variance(
                x, src_mask, self.pitch_predictor, self.pitch_embedding,
                self.pitch_bins, control["pitch"],
            )
            x = x + emb

        log_duration_prediction = self.duration_predictor(x, src_mask)
        duration_rounded = torch.clamp(
            torch.round(torch.exp(log_duration_prediction) - 1.0) * control["duration"],
            min=0,
        ).to(torch.int32)
        duration_rounded = duration_rounded * src_mask.to(torch.int32)
        x, tgt_mask, mel_lens = length_regulate(x, duration_rounded, max_target_len)

        if vp.energy.level == "frame":
            energy_prediction, emb = self._variance(
                x, tgt_mask, self.energy_predictor, self.energy_embedding,
                self.energy_bins, control["energy"],
            )
            x = x + emb
        if vp.pitch.level == "frame":
            pitch_prediction, emb = self._variance(
                x, tgt_mask, self.pitch_predictor, self.pitch_embedding,
                self.pitch_bins, control["pitch"],
            )
            x = x + emb

        return {
            "output": x,
            "duration_prediction": log_duration_prediction,
            "duration_rounded": duration_rounded,
            "pitch_prediction": pitch_prediction,
            "energy_prediction": energy_prediction,
            "target_mask": tgt_mask,
            "mel_lens": mel_lens,
        }
