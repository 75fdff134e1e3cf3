"""FastSpeech2 text-to-mel model (counterpart of the JAX package's
``models/fastspeech2.py:125-239``): ``forward`` with ``inference=True,
deterministic=True``, and ``forward_train``, the training forward
(``inference=False, deterministic=False``) over a batch of tensors.

Text embedding + FastPitch positions -> Conformer encoder -> speaker /
language embeddings -> variance adaptor -> Conformer decoder -> mel linear
-> PostNet. ``model.dtype = "bfloat16"`` computes in bf16 wherever the JAX
model passes ``dtype=dt``; the variance heads and the mel outputs stay f32,
and so do the speaker and language embeddings (whose sum promotes the
encoder output to f32, as in JAX)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import CHARACTERS, FastSpeech2Config
from ..ops.masking import mask_from_lens
from .conformer import Conformer
from .layers import Embedding, Linear, PostNet, fastpitch_positional_embedding
from .variance_adaptor import VarianceAdaptor

def compute_dtype(config: FastSpeech2Config) -> torch.dtype:
    return torch.bfloat16 if config.model.dtype == "bfloat16" else torch.float32


class FastSpeech2(nn.Module):
    def __init__(self, config: FastSpeech2Config, n_symbols: int,
                 n_speakers: int = 1, n_languages: int = 1):
        super().__init__()
        mcfg = config.model
        if mcfg.target_text_representation_level != CHARACTERS:
            raise NotImplementedError(
                f"{mcfg.target_text_representation_level!r}-level models are not "
                "ported yet (later slice: phones/pfs input)"
            )
        if mcfg.use_global_style_token_module:
            raise NotImplementedError(
                "global style tokens are not ported yet (later slice: GST)"
            )
        self.config = config
        dt = compute_dtype(config)
        self.compute_dtype = dt
        d = mcfg.encoder.input_dim
        n_mels = config.preprocessing.audio.n_mels
        self.text_input_layer = Embedding(n_symbols, d, dtype=dt)
        self.position_embedding = _PositionEmbedding(d)
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
    ) -> Dict[str, torch.Tensor]:
        if control is None:
            control = {"pitch": 1.0, "energy": 1.0, "duration": 1.0}
        _, x, src_mask = self._encode(text, src_lens, speaker_id, language_id)
        va = self.variance_adaptor(x, src_mask, control, max_target_len)
        tgt_mask = va["target_mask"]
        output, postnet_output = self._decode(va["output"], tgt_mask, x.dtype)
        return {
            "output": output,
            "postnet_output": postnet_output,
            "src_mask": src_mask,
            "tgt_mask": tgt_mask,
            "tgt_lens": va["mel_lens"],
            "duration_prediction": va["duration_prediction"],
            "duration_rounded": va["duration_rounded"],
            "pitch_prediction": va["pitch_prediction"],
            "energy_prediction": va["energy_prediction"],
        }

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """Training forward: `batch` holds the loader's arrays as tensors on
        the model's device (text, src_lens, mel, mel_lens, pitch, energy,
        attn_prior or duration, speaker_id, language_id); `gen` draws every
        dropout mask and attention seed. Returns the keys ``compute_loss``
        reads."""
        inputs, x, src_mask = self._encode(batch["text"], batch["src_lens"],
                                           batch.get("speaker_id"),
                                           batch.get("language_id"), gen)
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

    def _encode(self, text, src_lens, speaker_id, language_id, gen=None):
        """(text embeddings, encoder output with the speaker and language
        embeddings added, source mask)."""
        mcfg = self.config.model
        L = text.shape[1]
        src_mask = mask_from_lens(src_lens, L)
        inputs = self.text_input_layer(text)
        positions = torch.arange(L, dtype=torch.float32, device=text.device)
        enc_pos = fastpitch_positional_embedding(positions, mcfg.encoder.input_dim,
                                                 dtype=inputs.dtype)
        enc_pos = enc_pos[None] * src_mask[:, :, None].to(inputs.dtype)
        x = self.encoder(inputs + enc_pos, src_mask, gen)
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
