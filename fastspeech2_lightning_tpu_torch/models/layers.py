"""Shared layers: positional embedding, variance predictors, PostNet, and the
compute-dtype building blocks (counterpart of the JAX package's
``models/layers.py``).

Parameters are always float32, as in the JAX package; a layer built with
``dtype=torch.bfloat16`` casts its input and its weights to bf16 at call
time, which is what flax does for a module with ``dtype=bf16``. LayerNorm and
BatchNorm normalize in f32 and cast the result to the compute dtype.

Activations are [B, T, C]; submodule names follow the reference state_dict
layout (``models/torch_export.py``), so an exported checkpoint loads with
``load_state_dict(strict=True)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def fastpitch_positional_embedding(
    positions: torch.Tensor, dim: int, dtype=torch.float32
) -> torch.Tensor:
    """FastPitch sinusoidal embedding, positions [T] f32 -> [T, dim]; the
    layout is [sin(all freqs), cos(all freqs)] concatenated, not
    interleaved (``layers.py:47-58``)."""
    inv_freq = 1.0 / (
        10000 ** (torch.arange(0.0, dim, 2.0, device=positions.device) / dim)
    )
    sinusoid = positions[:, None] * inv_freq[None, :]
    emb = torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=1)
    return emb[:, :dim].to(dtype)


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv1d(nn.Conv1d):
    """Conv over [B, C, T] with SAME padding in the compute dtype."""

    def __init__(self, in_ch, out_ch, kernel_size, groups=1, bias=True,
                 dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, padding="same",
                         groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class Embedding(nn.Embedding):
    def __init__(self, num, dim, dtype=torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim, eps=1e-5, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """Eval-mode BatchNorm over the channels of [B, T, C] with the running
    statistics, normalized in f32 and cast to the compute dtype. Training
    statistics come with the training slice."""

    def __init__(self, channels, eps=1e-5, dtype=torch.float32):
        super().__init__(channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "batch statistics are not ported yet (later slice: training)"
            )
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return (y * self.weight + self.bias).to(self.compute_dtype)


class TransposedConv(nn.Module):
    """Runs a [B, C, T] conv `module` on [B, T, C] activations."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x):
        return self.module(x.transpose(1, 2)).transpose(1, 2)


class DepthwiseSeparableConv1d(nn.Module):
    """Depthwise conv + pointwise conv over [B, C, T] (fs2/blocks.py:4-19)."""

    def __init__(self, in_ch, out_ch, kernel_size, dtype=torch.float32):
        super().__init__()
        self.model = nn.Sequential(
            Conv1d(in_ch, in_ch, kernel_size, groups=in_ch, dtype=dtype),
            Conv1d(in_ch, out_ch, 1, dtype=dtype),
        )

    def forward(self, x):
        return self.model(x)


class VarianceConvolutionLayer(nn.Module):
    """Conv (plain or depthwise-separable) + ReLU + LayerNorm (+ dropout,
    identity at inference)."""

    def __init__(self, in_ch, out_ch, kernel_size, depthwise, dtype=torch.float32):
        super().__init__()
        conv = (
            DepthwiseSeparableConv1d(in_ch, out_ch, kernel_size, dtype=dtype)
            if depthwise
            else Conv1d(in_ch, out_ch, kernel_size, dtype=dtype)
        )
        self.layers = nn.Sequential(
            TransposedConv(conv), nn.ReLU(), LayerNorm(out_ch, dtype=dtype),
            nn.Identity(),
        )

    def forward(self, x):
        return self.layers(x)


class VariancePredictor(nn.Module):
    """N conv layers + linear scalar head; the head's output is f32 and
    masked (``layers.py:133-166``)."""

    def __init__(self, in_dim, n_layers, n_channels, kernel_size, depthwise,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv = nn.ModuleList(
            VarianceConvolutionLayer(
                in_dim if i == 0 else n_channels, n_channels, kernel_size,
                depthwise, dtype=dtype,
            )
            for i in range(n_layers)
        )
        self.linear = Linear(n_channels, 1, dtype=dtype)

    def forward(self, x, mask=None):
        x = x.to(self.compute_dtype)
        for layer in self.conv:
            x = layer(x)
        out = self.linear(x).squeeze(-1).float()
        if mask is not None:
            out = out * mask.to(out.dtype)
        return out


class ConvNorm(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size, dtype=torch.float32):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, kernel_size, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class PostNet(nn.Module):
    """Five convs (512 channels, kernel 5), each with eval BatchNorm, tanh on
    all but the last (``layers.py:169-212``); the caller adds the residual."""

    def __init__(self, n_mels=80, dim=512, kernel_size=5, n_convs=5,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.convolutions = nn.ModuleList()
        for i in range(n_convs):
            cin = n_mels if i == 0 else dim
            cout = n_mels if i == n_convs - 1 else dim
            self.convolutions.append(
                nn.Sequential(
                    ConvNorm(cin, cout, kernel_size, dtype=dtype),
                    BatchNorm1d(cout, dtype=dtype),
                )
            )

    def forward(self, x):
        x = x.to(self.compute_dtype).transpose(1, 2)  # [B, C, T]
        n = len(self.convolutions)
        for i, (conv, bn) in enumerate(self.convolutions):
            x = conv(x)
            x = bn(x.transpose(1, 2)).transpose(1, 2)
            if i < n - 1:
                x = torch.tanh(x)
        return x.transpose(1, 2)
