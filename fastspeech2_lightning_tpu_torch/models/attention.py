"""Learned text<->mel alignment attention (counterpart of the JAX package's
``models/attention.py::ConvAttention``), declared with its parameters so a
checkpoint's state_dict loads strictly. Only training and teacher forcing
run it; its forward comes with the training slice."""

from __future__ import annotations

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

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "the alignment attention runs only in training and teacher "
            "forcing, which are not ported yet (later slice: training)"
        )
