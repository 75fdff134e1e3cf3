"""Learned text<->mel alignment attention (counterpart of the JAX package's
``models/attention.py::ConvAttention``, ``:86-142``).

Keys (text embeddings) pass a conv(k=3) -> ReLU -> conv(k=1) encoder and
queries (mel frames) a 3xconv encoder; scores are the Gaussian-isotropic
log-likelihood ``-0.0005 * |q - k|^2``, expanded as ``|q|^2 + |k|^2 - 2 q.k``,
plus ``log(prior + 1e-8)`` after a log-softmax when a prior is given. The
flax module has no ``dtype``, so the whole module runs in f32 whatever the
model's compute dtype. ``attn_logprob`` is taken before the key mask; the
mask puts -inf on padded keys before the softmax."""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvNorm


class ConvAttention(nn.Module):
    def __init__(self, n_mel_channels=80, n_text_channels=256, n_att_channels=80):
        super().__init__()
        self.key_proj = nn.Sequential(
            ConvNorm(n_text_channels, n_text_channels * 2, 3),
            nn.ReLU(),
            ConvNorm(n_text_channels * 2, n_att_channels, 1),
        )
        self.query_proj = nn.Sequential(
            ConvNorm(n_mel_channels, n_mel_channels * 2, 3),
            nn.ReLU(),
            ConvNorm(n_mel_channels * 2, n_mel_channels, 1),
            nn.ReLU(),
            ConvNorm(n_mel_channels, n_att_channels, 1),
        )

    def forward(self, queries, keys, key_mask=None, attn_prior=None):
        """queries [B, T_mel, n_mel], keys [B, L, n_text], key_mask [B, L]
        (True valid), attn_prior [B, T_mel, L] -> (attn [B, T_mel, L]
        softmaxed over the text, attn_logprob [B, T_mel, L])."""
        k = self.key_proj(keys.float().transpose(1, 2)).transpose(1, 2)
        q = self.query_proj(queries.float().transpose(1, 2)).transpose(1, 2)
        q_sq = (q * q).sum(-1, keepdim=True)  # [B, T_mel, 1]
        k_sq = (k * k).sum(-1)[:, None, :]  # [B, 1, L]
        cross = torch.matmul(q, k.transpose(1, 2))
        attn = -0.0005 * (q_sq + k_sq - 2.0 * cross)
        if attn_prior is not None:
            attn = torch.log_softmax(attn, dim=-1) + torch.log(attn_prior.float() + 1e-8)
        attn_logprob = attn
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, :], attn, -torch.inf)
        return torch.softmax(attn, dim=-1), attn_logprob
