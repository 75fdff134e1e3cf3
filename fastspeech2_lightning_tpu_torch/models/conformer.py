"""Conformer encoder/decoder (counterpart of the JAX package's
``models/conformer.py``).

Per layer: half-step FFN, self-attention, convolution module (pointwise ->
GLU -> depthwise -> BatchNorm -> SiLU -> pointwise), half-step FFN, final
LayerNorm; activations [B, T, C]. Padding is zeroed before the depthwise conv
and the stack's output is masked, so outputs do not depend on bucket padding.
Self-attention runs through ``ops.attention.attention_fwd`` (the CUDA kernel
on the card) with key bias 0 / -1e9. In training (a generator ``gen`` is
given) dropout acts at the JAX package's sites: twice in each FFN, on the
attention output, on the conv module's output, and on the attention
probabilities at ``attention_dropout`` (None follows ``dropout``) through
``ops.attention.attention_with_dropout`` at any p, 0 included; the conv
module's BatchNorm takes the valid frames' batch statistics. Module names
follow torchaudio's
Conformer as the reference state_dict has them (``in_proj_weight`` holds
q;k;v, each head-major)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG_INF, attention_fwd, attention_with_dropout
from ..parallel.mesh import layout as parallel_layout
from ..parallel.tensor_parallel import ColumnParallelLinear, copy_to_group
from .layers import BatchNorm1d, Conv1d, LayerNorm, Linear, fast_dropout


class FeedForwardModule(nn.Module):
    def __init__(self, d, ffn_dim, dtype, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.sequential = nn.Sequential(
            LayerNorm(d, dtype=dtype), Linear(d, ffn_dim, dtype=dtype), nn.SiLU(),
            nn.Identity(), Linear(ffn_dim, d, dtype=dtype), nn.Identity(),
        )

    def forward(self, x, gen=None):
        s = self.sequential
        # under tensor parallelism s[1] and s[4] are the column- and
        # row-parallel Linears (parallel/mesh.py shard_model)
        x = fast_dropout(F.silu(s[1](s[0](x))), self.dropout, gen,
                         split_cols=isinstance(s[1], ColumnParallelLinear))
        return fast_dropout(s[4](x), self.dropout, gen)


class SelfAttention(nn.Module):
    """Multi-head self-attention with torchaudio/nn.MultiheadAttention's
    parameter names; its input LayerNorm lives in the layer
    (``self_attn_layer_norm``). Under tensor parallelism (``shard``) it
    holds its model rank's heads: their q, k and v rows of ``in_proj`` and
    their columns of ``out_proj``, whose products are summed over the model
    group. The attention dropout mask is drawn for the global (row, head)
    of each local one, so it is a one-process run's."""

    def __init__(self, d, heads, dtype, dropout=0.0, attention_dropout=None):
        super().__init__()
        self.heads = heads
        self.compute_dtype = dtype
        self.dropout = dropout
        self.attention_dropout = dropout if attention_dropout is None else attention_dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.split = False

    def shard(self) -> None:
        """Keep this model rank's heads (parallel/mesh.py shard_model)."""
        from ..parallel.mesh import HEADS, ShardSpec, shard_tensor
        from ..parallel.tensor_parallel import RowParallelLinear

        lay = parallel_layout()
        for name in ("in_proj_weight", "in_proj_bias"):
            full = getattr(self, name)
            part = shard_tensor(full.detach(), ShardSpec(HEADS, tuple(full.shape)),
                                lay.model_rank, lay.model_size)
            setattr(self, name, nn.Parameter(part.clone()))
        self.out_proj = RowParallelLinear.from_linear(self.out_proj)
        self.split = True

    def forward(self, x, mask, gen=None):
        B, T, d = x.shape
        h, head0 = self.heads, 0
        dh = d // h
        dt = self.compute_dtype
        x = x.to(dt)
        lay = parallel_layout()
        if self.split:
            h //= lay.model_size
            head0 = lay.model_rank * h
            x = copy_to_group(x, lay.model_group)
        qkv = F.linear(x, self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        # [B, T, 3, h, dh] -> three [B, h, T, dh] strided views
        qkv = qkv.view(B, T, 3, h, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        key_bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        scale = 1.0 / math.sqrt(dh)
        if gen is None:
            out = attention_fwd(q, k, v, key_bias, scale)
        else:
            # one int32 seed per call from the step's generator, as the JAX
            # conformer draws it from its dropout rng (conformer.py:163-166)
            seed = torch.randint(-(2**31), 2**31 - 1, (1,), generator=gen,
                                 device=x.device, dtype=torch.int32)
            out = attention_with_dropout(q, k, v, key_bias, seed,
                                         float(self.attention_dropout), scale,
                                         row_offset=lay.data_rank * B, head_offset=head0,
                                         heads_total=self.heads)
        out = out.transpose(1, 2).reshape(B, T, h * dh)
        return fast_dropout(self.out_proj(out), self.dropout, gen)


class ConvolutionModule(nn.Module):
    def __init__(self, d, kernel_size, dtype, dropout=0.0):
        super().__init__()
        self.compute_dtype = dtype
        self.dropout = dropout
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

    def forward(self, x, mask, gen=None):
        s = self.sequential
        x = self.layer_norm(x)
        x = s[0](x.transpose(1, 2))  # pointwise, [B, 2d, T]
        x = F.glu(x, dim=1)
        # keep padding out of the depthwise receptive field
        x = x * mask[:, None, :].to(x.dtype)
        x = s[2](x)
        # BatchNorm over [B, T, C]: valid frames' batch statistics in training
        x = s[3](x.transpose(1, 2), mask=mask, use_running_average=gen is None)
        x = F.silu(x)
        x = s[5](x.transpose(1, 2)).transpose(1, 2)
        return fast_dropout(x, self.dropout, gen)


class ConformerLayer(nn.Module):
    def __init__(self, d, heads, ffn_dim, kernel_size, dtype, dropout=0.0,
                 attention_dropout=None):
        super().__init__()
        self.ffn1 = FeedForwardModule(d, ffn_dim, dtype, dropout)
        self.self_attn_layer_norm = LayerNorm(d, dtype=dtype)
        self.self_attn = SelfAttention(d, heads, dtype, dropout, attention_dropout)
        self.conv_module = ConvolutionModule(d, kernel_size, dtype, dropout)
        self.ffn2 = FeedForwardModule(d, ffn_dim, dtype, dropout)
        self.final_layer_norm = LayerNorm(d, dtype=dtype)

    def forward(self, x, mask, gen=None):
        x = x + 0.5 * self.ffn1(x, gen)
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask, gen)
        x = x + self.conv_module(x, mask, gen)
        x = x + 0.5 * self.ffn2(x, gen)
        return self.final_layer_norm(x)


class Conformer(nn.Module):
    """Stack of ConformerLayers over [B, T, C] with a [B, T] validity mask."""

    def __init__(self, d, layers, heads, ffn_dim, kernel_size, dtype=torch.float32,
                 dropout=0.0, attention_dropout=None):
        super().__init__()
        self.compute_dtype = dtype
        self.conformer_layers = nn.ModuleList(
            ConformerLayer(d, heads, ffn_dim, kernel_size, dtype, dropout, attention_dropout)
            for _ in range(layers)
        )

    def forward(self, x, mask, gen=None):
        x = x.to(self.compute_dtype)
        for layer in self.conformer_layers:
            x = layer(x, mask, gen)
        return x * mask[:, :, None].to(x.dtype)
