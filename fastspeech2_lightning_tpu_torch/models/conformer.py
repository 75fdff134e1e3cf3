"""Conformer encoder/decoder, eval mode (counterpart of the JAX package's
``models/conformer.py``).

Per layer: half-step FFN, self-attention, convolution module (pointwise ->
GLU -> depthwise -> BatchNorm -> SiLU -> pointwise), half-step FFN, final
LayerNorm; activations [B, T, C]. Padding is zeroed before the depthwise conv
and the stack's output is masked, so outputs do not depend on bucket padding.
Self-attention runs through ``ops.attention.attention_fwd`` (the CUDA kernel
on the card) with key bias 0 / -1e9. Module names follow torchaudio's
Conformer as the reference state_dict has them (``in_proj_weight`` holds
q;k;v, each head-major)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG_INF, attention_fwd
from .layers import BatchNorm1d, Conv1d, LayerNorm, Linear


class FeedForwardModule(nn.Module):
    def __init__(self, d, ffn_dim, dtype):
        super().__init__()
        self.sequential = nn.Sequential(
            LayerNorm(d, dtype=dtype), Linear(d, ffn_dim, dtype=dtype), nn.SiLU(),
            nn.Identity(), Linear(ffn_dim, d, dtype=dtype), nn.Identity(),
        )

    def forward(self, x):
        return self.sequential(x)


class SelfAttention(nn.Module):
    """Multi-head self-attention with torchaudio/nn.MultiheadAttention's
    parameter names; its input LayerNorm lives in the layer
    (``self_attn_layer_norm``)."""

    def __init__(self, d, heads, dtype):
        super().__init__()
        self.heads = heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, mask):
        B, T, d = x.shape
        h = self.heads
        dh = d // h
        dt = self.compute_dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        # [B, T, 3, h, dh] -> three [B, h, T, dh] strided views
        qkv = qkv.view(B, T, 3, h, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        key_bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        out = attention_fwd(q, k, v, key_bias, 1.0 / math.sqrt(dh))
        out = out.transpose(1, 2).reshape(B, T, d)
        return self.out_proj(out)


class ConvolutionModule(nn.Module):
    def __init__(self, d, kernel_size, dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.layer_norm = LayerNorm(d, dtype=dtype)
        self.sequential = nn.Sequential(
            Conv1d(d, 2 * d, 1, dtype=dtype),
            nn.GLU(dim=1),
            Conv1d(d, d, kernel_size, groups=d, dtype=dtype),
            BatchNorm1d(d, dtype=dtype),
            nn.SiLU(),
            Conv1d(d, d, 1, dtype=dtype),
            nn.Identity(),
        )

    def forward(self, x, mask):
        s = self.sequential
        x = self.layer_norm(x)
        x = s[0](x.transpose(1, 2))  # pointwise, [B, 2d, T]
        x = F.glu(x, dim=1)
        # keep padding out of the depthwise receptive field
        x = x * mask[:, None, :].to(x.dtype)
        x = s[2](x)
        x = s[3](x.transpose(1, 2))  # eval BatchNorm over [B, T, C]
        x = F.silu(x)
        x = s[5](x.transpose(1, 2)).transpose(1, 2)
        return x


class ConformerLayer(nn.Module):
    def __init__(self, d, heads, ffn_dim, kernel_size, dtype):
        super().__init__()
        self.ffn1 = FeedForwardModule(d, ffn_dim, dtype)
        self.self_attn_layer_norm = LayerNorm(d, dtype=dtype)
        self.self_attn = SelfAttention(d, heads, dtype)
        self.conv_module = ConvolutionModule(d, kernel_size, dtype)
        self.ffn2 = FeedForwardModule(d, ffn_dim, dtype)
        self.final_layer_norm = LayerNorm(d, dtype=dtype)

    def forward(self, x, mask):
        x = x + 0.5 * self.ffn1(x)
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask)
        x = x + self.conv_module(x, mask)
        x = x + 0.5 * self.ffn2(x)
        return self.final_layer_norm(x)


class Conformer(nn.Module):
    """Stack of ConformerLayers over [B, T, C] with a [B, T] validity mask."""

    def __init__(self, d, layers, heads, ffn_dim, kernel_size, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conformer_layers = nn.ModuleList(
            ConformerLayer(d, heads, ffn_dim, kernel_size, dtype) for _ in range(layers)
        )

    def forward(self, x, mask):
        x = x.to(self.compute_dtype)
        for layer in self.conformer_layers:
            x = layer(x, mask)
        return x * mask[:, :, None].to(x.dtype)
