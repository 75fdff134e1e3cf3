"""FastSpeech2 text-to-mel model (counterpart of the JAX package's
``models/fastspeech2.py:125-239``): ``forward`` with ``inference=True,
deterministic=True``; ``forward_teacher_forced``, the same with
``teacher_forcing=True`` over a batch holding target mels; and
``forward_train``, the training forward (``inference=False,
deterministic=False``) over a batch of tensors.

Text embedding (or, for a phonological-feature model, a bias-free Linear
over the feature vectors) + FastPitch positions -> Conformer encoder ->
global style embedding -> speaker / language embeddings -> variance adaptor
-> Conformer decoder -> mel linear -> PostNet. ``model.dtype = "bfloat16"``
computes in bf16 wherever the JAX model passes ``dtype=dt``; the variance
heads and the mel outputs stay f32, and so do the speaker and language
embeddings (whose sum promotes the encoder output to f32, as in JAX). The
style encoder computes in f32 and its output is cast to the encoder's
dtype before it is added.

The style (``fastspeech2.py:164-174``): in training and under teacher
forcing from the batch's padded ``mel`` (BatchNorm on batch statistics in
training, on running ones otherwise), unless a ``mel_style_reference`` is
given at inference; free-running inference without one attends to style
token 0."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import PHONOLOGICAL_FEATURES, FastSpeech2Config
from ..ops.masking import mask_from_lens
from ..text.features import N_PHONOLOGICAL_FEATURES
from .conformer import Conformer
from .gst import StyleEncoder
from .layers import Embedding, Linear, PostNet, fastpitch_positional_embedding
from .variance_adaptor import VarianceAdaptor

def compute_dtype(config: FastSpeech2Config) -> torch.dtype:
    return torch.bfloat16 if config.model.dtype == "bfloat16" else torch.float32


class FastSpeech2(nn.Module):
    def __init__(self, config: FastSpeech2Config, n_symbols: int,
                 n_speakers: int = 1, n_languages: int = 1):
        super().__init__()
        mcfg = config.model
        self.config = config
        dt = compute_dtype(config)
        self.compute_dtype = dt
        d = mcfg.encoder.input_dim
        n_mels = config.preprocessing.audio.n_mels
        self.uses_pfs = mcfg.target_text_representation_level == PHONOLOGICAL_FEATURES
        if self.uses_pfs:
            self.text_input_layer = Linear(N_PHONOLOGICAL_FEATURES, d, bias=False, dtype=dt)
        else:
            self.text_input_layer = Embedding(n_symbols, d, dtype=dt)
        self.position_embedding = _PositionEmbedding(d)
        if mcfg.use_global_style_token_module:
            # added to the encoder output, so as wide as the encoder
            self.gst = StyleEncoder(idim=n_mels, gst_token_dim=d)
        enc, dec = mcfg.encoder, mcfg.decoder
        self.encoder = Conformer(d, enc.layers, enc.heads, enc.feedforward_dim,
                                 enc.conv_kernel_size, dtype=dt, dropout=enc.dropout,
                                 attention_dropout=enc.attention_dropout)
        self.variance_adaptor = VarianceAdaptor(config, dtype=dt)
        self.decoder = Conformer(dec.input_dim, dec.layers, dec.heads,
                                 dec.feedforward_dim, dec.conv_kernel_size, dtype=dt,
                                 dropout=dec.dropout,
                                 attention_dropout=dec.attention_dropout)
        self.mel_linear = Linear(dec.input_dim, n_mels, dtype=dt)
        if mcfg.use_postnet:
            self.postnet = PostNet(n_mels=n_mels, dtype=dt)
        if mcfg.multispeaker:
            self.speaker_embedding = nn.Embedding(n_speakers, d)
        if mcfg.multilingual:
            self.language_embedding = nn.Embedding(n_languages, d)

    @torch.inference_mode()
    def forward(
        self,
        text: torch.Tensor,  # [B, L] int symbol ids
        src_lens: torch.Tensor,  # [B] int
        max_target_len: int,
        control: Optional[Dict[str, float]] = None,
        speaker_id: Optional[torch.Tensor] = None,
        language_id: Optional[torch.Tensor] = None,
        pfs: Optional[torch.Tensor] = None,  # [B, L, N_PHONOLOGICAL_FEATURES]
        mel_style_reference: Optional[torch.Tensor] = None,  # [B, T_ref, n_mels]
    ) -> Dict[str, torch.Tensor]:
        if control is None:
            control = {"pitch": 1.0, "energy": 1.0, "duration": 1.0}
        _, x, src_mask = self._encode(text, src_lens, speaker_id, language_id, pfs=pfs,
                                      style_mel=mel_style_reference)
        va = self.variance_adaptor(x, src_mask, control, max_target_len)
        return self._inference_outputs(va, x, src_mask, va["mel_lens"])

    @torch.inference_mode()
    def forward_teacher_forced(self, batch: Dict[str, torch.Tensor],
                               control: Optional[Dict[str, float]] = None
                               ) -> Dict[str, torch.Tensor]:
        """The inference forward with the durations taken from the batch's
        target mels (text, src_lens, mel, mel_lens, attn_prior or duration,
        speaker_id, language_id, and pfs and mel_style_reference where the
        model takes them): the mel comes out at the batch's mel width,
        ``tgt_lens`` is ``mel_lens`` and ``duration_rounded`` the durations.
        It also returns the keys ``compute_loss`` scores
        (``fastspeech2.py:221-239``): ``src_lens``, the alignment's
        ``attn_logprob``, ``attn_soft`` and ``attn_hard``,
        ``duration_target``, and ``pitch_target`` and ``energy_target``,
        which are None at inference."""
        if control is None:
            control = {"pitch": 1.0, "energy": 1.0, "duration": 1.0}
        style = batch.get("mel_style_reference")
        inputs, x, src_mask = self._encode(batch["text"], batch["src_lens"],
                                           batch.get("speaker_id"), batch.get("language_id"),
                                           pfs=batch.get("pfs"),
                                           style_mel=batch["mel"] if style is None else style)
        va = self.variance_adaptor.forward_teacher_forced(inputs, x, batch, src_mask, control)
        out = self._inference_outputs(va, x, src_mask, batch["mel_lens"])
        out.update({k: va[k] for k in ("attn_logprob", "attn_soft", "attn_hard",
                                       "duration_target", "pitch_target", "energy_target")},
                   src_lens=batch["src_lens"])
        return out

    def _inference_outputs(self, va, x, src_mask, tgt_lens) -> Dict[str, torch.Tensor]:
        tgt_mask = va["target_mask"]
        output, postnet_output = self._decode(va["output"], tgt_mask, x.dtype)
        return {
            "output": output,
            "postnet_output": postnet_output,
            "src_mask": src_mask,
            "tgt_mask": tgt_mask,
            "tgt_lens": tgt_lens,
            "duration_prediction": va["duration_prediction"],
            "duration_rounded": va["duration_rounded"],
            "pitch_prediction": va["pitch_prediction"],
            "energy_prediction": va["energy_prediction"],
        }

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      gen: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Training forward: `batch` holds the loader's arrays as tensors on
        the model's device (text, src_lens, mel, mel_lens, pitch, energy,
        attn_prior or duration, speaker_id, language_id, pfs); `gen` draws
        every dropout mask and attention seed, and None is the JAX package's
        ``deterministic=True`` (the eval step). Returns the keys
        ``compute_loss`` reads."""
        inputs, x, src_mask = self._encode(batch["text"], batch["src_lens"],
                                           batch.get("speaker_id"),
                                           batch.get("language_id"), gen, pfs=batch.get("pfs"),
                                           style_mel=batch["mel"])
        va = self.variance_adaptor.forward_train(inputs, x, batch, src_mask, gen)
        tgt_mask = va["target_mask"]
        output, postnet_output = self._decode(va["output"], tgt_mask, x.dtype, gen)
        return {
            "output": output,
            "postnet_output": postnet_output,
            "src_mask": src_mask,
            "src_lens": batch["src_lens"],
            "tgt_mask": tgt_mask,
            "tgt_lens": batch["mel_lens"],
            "attn_logprob": va["attn_logprob"],
            "attn_soft": va["attn_soft"],
            "attn_hard": va["attn_hard"],
            "duration_prediction": va["duration_prediction"],
            "duration_target": va["duration_target"],
            "duration_rounded": va["duration_target"],
            "energy_prediction": va["energy_prediction"],
            "energy_target": va["energy_target"],
            "pitch_prediction": va["pitch_prediction"],
            "pitch_target": va["pitch_target"],
        }

    def _encode(self, text, src_lens, speaker_id, language_id, gen=None, pfs=None,
                style_mel=None):
        """(text embeddings, encoder output with the style, speaker and
        language embeddings added, source mask). A phonological-feature
        model reads `pfs` in place of `text`; a GST model takes its style
        from `style_mel`, or from token 0 when that is None."""
        mcfg = self.config.model
        if self.uses_pfs:
            if pfs is None:
                raise ValueError("a phonological-feature model needs the batch's pfs "
                                 "[B, L, N_PHONOLOGICAL_FEATURES]")
            text = pfs
        L = text.shape[1]
        src_mask = mask_from_lens(src_lens, L)
        inputs = self.text_input_layer(text)
        positions = torch.arange(L, dtype=torch.float32, device=text.device)
        enc_pos = fastpitch_positional_embedding(positions, mcfg.encoder.input_dim,
                                                 dtype=inputs.dtype)
        enc_pos = enc_pos[None] * src_mask[:, :, None].to(inputs.dtype)
        x = self.encoder(inputs + enc_pos, src_mask, gen)
        if mcfg.use_global_style_token_module:
            if style_mel is None:
                style = self.gst.condition_on_gst_tokens(text.shape[0])
            else:
                style = self.gst(style_mel, use_running_average=gen is None)
            x = x + style[:, None, :].to(x.dtype)
        if mcfg.multispeaker:
            x = x + self.speaker_embedding(speaker_id)[:, None, :]
        if mcfg.multilingual:
            x = x + self.language_embedding(language_id)[:, None, :]
        return inputs, x, src_mask

    def _decode(self, frames, tgt_mask, pos_dtype, gen=None):
        """(mel, PostNet mel or None) in f32 from the variance adaptor's
        frame-rate output; the decoder positions take `pos_dtype`, the
        encoder output's."""
        mcfg = self.config.model
        T = frames.shape[1]
        dec_positions = torch.arange(T, dtype=torch.float32, device=frames.device)
        dec_pos = fastpitch_positional_embedding(dec_positions, mcfg.decoder.input_dim,
                                                 dtype=pos_dtype)
        dec_pos = dec_pos[None] * tgt_mask[:, :, None].to(pos_dtype)
        x = self.decoder(frames + dec_pos, tgt_mask, gen)
        output = self.mel_linear(x).float()
        postnet_output = None
        if mcfg.use_postnet:
            postnet_output = output + self.postnet(output, gen).float()
        return output, postnet_output


class _PositionEmbedding(nn.Module):
    """Holds the reference layout's ``position_embedding.inv_freq`` buffer;
    the forward computes the same frequencies in
    ``fastpitch_positional_embedding``."""

    def __init__(self, d: int):
        super().__init__()
        self.register_buffer(
            "inv_freq", 1.0 / (10000.0 ** (torch.arange(0.0, d, 2.0) / d))
        )
