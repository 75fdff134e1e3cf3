"""Variance adaptor (counterpart of the JAX package's
``models/variance_adaptor.py``): pitch/energy predictors with bucketized
embeddings, the duration predictor and the length regulator.

``forward`` is the inference branch (``:178-228``): embeddings of the
predictions, rounded predicted durations. ``forward_teacher_forced`` is the
teacher-forced inference branch (``:151-232`` with ``teacher_forcing`` and
``inference``): the durations come from the alignment attention on the
target mel and MAS (or from the batch without learned alignment), the rest
is the inference branch. ``forward_train`` is the training branch
(``:151-213``): the alignment attention and MAS give the durations, the
frame targets are averaged over them, and the embeddings and the length
regulator take the targets."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.length_regulator import length_regulate
from ..ops.mas import mas_width1
from ..ops.variance import average_variance, bucketize
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
                d, c.n_layers, c.input_dim, c.kernel_size, c.depthwise,
                dropout=c.dropout, dtype=dtype,
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
        durations: Optional[torch.Tensor] = None,  # [B, L] int; None: predicted
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
        if durations is None:
            durations = torch.clamp(
                torch.round(torch.exp(log_duration_prediction) - 1.0) * control["duration"],
                min=0,
            ).to(torch.int32)
            durations = durations * src_mask.to(torch.int32)
        x, tgt_mask, mel_lens = length_regulate(x, durations, max_target_len)

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
            "duration_rounded": durations,
            "pitch_prediction": pitch_prediction,
            "energy_prediction": energy_prediction,
            "target_mask": tgt_mask,
            "mel_lens": mel_lens,
        }

    def forward_teacher_forced(
        self,
        text_emb: torch.Tensor,  # [B, L, D] raw text embeddings (aligner keys)
        x: torch.Tensor,  # [B, L, D] encoder output (+ speaker/language)
        batch: Dict[str, torch.Tensor],
        src_mask: torch.Tensor,  # [B, L] bool
        control: Dict[str, float],
    ) -> Dict[str, torch.Tensor]:
        """The inference branch at the durations of the batch's target mel
        (MAS over the alignment attention, or ``batch["duration"]``), length
        regulated to the batch's mel width. Besides the inference outputs it
        returns what JAX's teacher-forced branch returns for the loss
        (``variance_adaptor.py:151-239``): the attention's log-probabilities,
        soft and hard alignments, the durations as ``duration_target``, and
        None for the pitch and energy targets (inference loads none)."""
        durations = batch.get("duration")
        attn_logprob = attn_soft = attn_hard = None
        if self.config.model.learn_alignment:
            attn_soft, attn_logprob = self.attention(
                batch["mel"], text_emb, key_mask=src_mask,
                attn_prior=batch.get("attn_prior"),
            )
            attn_hard, durations = mas_width1(
                torch.log(torch.clamp(attn_soft, min=1e-20)),
                batch["src_lens"], batch["mel_lens"],
            )
        out = self(x, src_mask, control, batch["mel"].shape[1], durations=durations)
        out.update(attn_logprob=attn_logprob, attn_soft=attn_soft, attn_hard=attn_hard,
                   duration_target=durations, pitch_target=None, energy_target=None)
        return out

    def forward_train(
        self,
        text_emb: torch.Tensor,  # [B, L, D] raw text embeddings (aligner keys)
        x: torch.Tensor,  # [B, L, D] encoder output (+ speaker/language)
        batch: Dict[str, torch.Tensor],
        src_mask: torch.Tensor,  # [B, L] bool
        gen: Optional[torch.Generator],  # None: deterministic
    ) -> Dict[str, torch.Tensor]:
        mcfg = self.config.model
        vp = mcfg.variance_predictors
        energy_target, pitch_target = batch["energy"], batch["pitch"]
        duration_target = batch.get("duration")
        attn_logprob = attn_soft = attn_hard = None
        if mcfg.learn_alignment:
            attn_soft, attn_logprob = self.attention(
                batch["mel"], text_emb, key_mask=src_mask,
                attn_prior=batch.get("attn_prior"),
            )
            # the search takes no gradient (reference: under no_grad)
            attn_hard, duration_target = mas_width1(
                torch.log(torch.clamp(attn_soft.detach(), min=1e-20)),
                batch["src_lens"], batch["mel_lens"],
            )
            if vp.energy.level == "phone":
                energy_target = average_variance(energy_target, duration_target)
            if vp.pitch.level == "phone":
                pitch_target = average_variance(pitch_target, duration_target)

        def variance(x, target, mask, predictor, embedding, bins):
            return predictor(x, mask, gen), embedding(bucketize(target, bins))

        energy_prediction = pitch_prediction = None
        if vp.energy.level == "phone":
            energy_prediction, emb = variance(
                x, energy_target, src_mask, self.energy_predictor,
                self.energy_embedding, self.energy_bins,
            )
            x = x + emb
        if vp.pitch.level == "phone":
            pitch_prediction, emb = variance(
                x, pitch_target, src_mask, self.pitch_predictor,
                self.pitch_embedding, self.pitch_bins,
            )
            x = x + emb
        log_duration_prediction = self.duration_predictor(x, src_mask, gen)
        x, tgt_mask, mel_lens = length_regulate(x, duration_target, batch["mel"].shape[1])
        if vp.energy.level == "frame":
            energy_prediction, emb = variance(
                x, energy_target, tgt_mask, self.energy_predictor,
                self.energy_embedding, self.energy_bins,
            )
            x = x + emb
        if vp.pitch.level == "frame":
            pitch_prediction, emb = variance(
                x, pitch_target, tgt_mask, self.pitch_predictor,
                self.pitch_embedding, self.pitch_bins,
            )
            x = x + emb
        return {
            "output": x,
            "attn_logprob": attn_logprob,
            "attn_soft": attn_soft,
            "attn_hard": attn_hard,
            "duration_prediction": log_duration_prediction,
            "duration_target": duration_target,
            "pitch_prediction": pitch_prediction,
            "pitch_target": pitch_target,
            "energy_prediction": energy_prediction,
            "energy_target": energy_target,
            "target_mask": tgt_mask,
            "mel_lens": mel_lens,
        }
