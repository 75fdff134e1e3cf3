"""Shared layers: positional embedding, variance predictors, PostNet, and the
compute-dtype building blocks (counterpart of the JAX package's
``models/layers.py``).

Parameters are always float32, as in the JAX package; a layer built with
``dtype=torch.bfloat16`` casts its input and its weights to bf16 at call
time, which is what flax does for a module with ``dtype=bf16``. LayerNorm and
BatchNorm normalize in f32 and cast the result to the compute dtype.

Activations are [B, T, C]; submodule names follow the reference state_dict
layout (``models/torch_export.py``), so an exported checkpoint loads with
``load_state_dict(strict=True)``.

Training randomness comes from an explicit ``torch.Generator`` passed down the
forward (``gen``); ``gen=None`` is the JAX package's ``deterministic=True``:
no dropout, and normalization from the running statistics."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import layout as parallel_layout


def fast_dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
                 split_cols: bool = False) -> torch.Tensor:
    """Dropout with the JAX package's FastDropout semantics
    (``layers.py:17-44``): the rate is quantized to t = round(256 * rate),
    one uint8 of random bits per element, keep iff bits >= t, kept values
    scaled by 256 / (256 - t) in x's dtype. Identity when `gen` is None.

    Under a data-parallel layout (``parallel.layout()``) x holds this data
    rank's rows of the global batch: the bits of the whole global tensor are
    drawn and this rank's block kept, so every rank's generator stays in
    step with a one-process run and the masks are that run's. `split_cols`
    (x comes out of a column-parallel Linear) says that x's last dim is this
    model rank's slice of the full one: the full width is drawn too."""
    if gen is None or rate == 0.0:
        return x
    t = int(round(rate * 256.0))
    if t <= 0:
        return x
    if t >= 256:
        return torch.zeros_like(x)
    lay = parallel_layout()
    if lay.data_size == 1 and not split_cols:
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, generator=gen,
                             device=x.device)
    else:
        shape = list(x.shape)
        shape[0] *= lay.data_size
        if split_cols:
            shape[-1] *= lay.model_size
        bits = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen, device=x.device)
        bits = bits.narrow(0, lay.data_rank * x.shape[0], x.shape[0])
        if split_cols:
            bits = bits.narrow(-1, lay.model_rank * x.shape[-1], x.shape[-1])
    scale = torch.tensor(256.0 / (256 - t), dtype=x.dtype, device=x.device)
    return torch.where(bits >= t, x * scale, torch.zeros_like(x))


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
        self.split = False

    def shard(self) -> None:
        """Keep this model rank's slice of the embedding dim; the forward
        gathers the full width over the model group."""
        lay = parallel_layout()
        n = self.embedding_dim // lay.model_size
        self.weight = nn.Parameter(
            self.weight.detach()[:, lay.model_rank * n:(lay.model_rank + 1) * n].clone())
        self.split = True

    def forward(self, ids):
        x = F.embedding(ids, self.weight)
        if self.split:
            from ..parallel.tensor_parallel import gather_last_dim

            x = gather_last_dim(x, parallel_layout().model_group)
        return x.to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim, eps=1e-5, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the channels of [B, T, C] (or of any [..., C]),
    normalized by the running statistics or by one of the JAX package's two
    batch-statistics forms; the result is cast to the compute dtype.

    - running statistics (``use_running_average=True``), normalized in f32;
    - ``mask`` given: the conformer's MaskedBatchNorm (``conformer.py:28-55``),
      statistics over the valid frames of [B, T, C] only, computed in x's
      dtype, biased variance;
    - no mask: flax ``nn.BatchNorm`` (the PostNet, and the style encoder's
      [B, T, F, C]), statistics in f32 over every position but the channel
      axis, padding included, variance E[x^2] - E[x]^2.

    Batch statistics update the running ones as running = 0.9 * running +
    0.1 * batch, with the biased variance (``nn.BatchNorm1d``'s own update
    takes the unbiased one, so it is written out here). Under a
    data-parallel layout the batch statistics are those of the global batch:
    each form's sums and counts are summed over the data group (with a
    gradient that is summed back) before they are divided, so the running
    statistics stay equal on every rank; over a group of one rank the sums
    are this process's, as they were before the layout existed."""

    MOMENTUM = 0.9

    def __init__(self, channels, eps=1e-5, dtype=torch.float32):
        super().__init__(channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x, mask=None, use_running_average: bool = True):
        from ..parallel.tensor_parallel import all_reduce_sum

        if use_running_average:
            y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return (y * self.weight + self.bias).to(self.compute_dtype)
        group = parallel_layout().data_group
        if mask is not None:
            m = mask[:, :, None].to(x.dtype)
            count = torch.clamp(all_reduce_sum(m.sum(), group), min=1.0)
            mean = all_reduce_sum((x * m).sum((0, 1)), group) / count
            var = all_reduce_sum((((x - mean) ** 2) * m).sum((0, 1)), group) / count
            y = ((x - mean) * torch.rsqrt(var + self.eps)).float() * self.weight + self.bias
        else:
            x32 = x.float()
            dims = tuple(range(x.ndim - 1))
            moments = torch.stack([x32.mean(dims), (x32 * x32).mean(dims)])
            # each rank's means weighted by its share of the positions (1.0
            # exactly over a group of one rank), summed over the group
            n = torch.full((), float(x32[..., 0].numel()), device=x.device)
            moments = all_reduce_sum(moments * (n / all_reduce_sum(n, group)), group)
            mean = moments[0]
            var = torch.clamp(moments[1] - mean * mean, min=0.0)
            y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        with torch.no_grad():
            k = self.MOMENTUM
            self.running_mean.copy_(k * self.running_mean + (1 - k) * mean.float())
            self.running_var.copy_(k * self.running_var + (1 - k) * var.float())
        return y.to(self.compute_dtype)


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
    """Conv (plain or depthwise-separable) + ReLU + LayerNorm + dropout."""

    def __init__(self, in_ch, out_ch, kernel_size, depthwise, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        conv = (
            DepthwiseSeparableConv1d(in_ch, out_ch, kernel_size, dtype=dtype)
            if depthwise
            else Conv1d(in_ch, out_ch, kernel_size, dtype=dtype)
        )
        self.dropout = dropout
        self.layers = nn.Sequential(
            TransposedConv(conv), nn.ReLU(), LayerNorm(out_ch, dtype=dtype),
            nn.Identity(),
        )

    def forward(self, x, gen=None):
        s = self.layers
        return fast_dropout(s[2](torch.relu(s[0](x))), self.dropout, gen)


class VariancePredictor(nn.Module):
    """N conv layers + linear scalar head; the head's output is f32 and
    masked (``layers.py:133-166``)."""

    def __init__(self, in_dim, n_layers, n_channels, kernel_size, depthwise,
                 dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv = nn.ModuleList(
            VarianceConvolutionLayer(
                in_dim if i == 0 else n_channels, n_channels, kernel_size,
                depthwise, dropout=dropout, dtype=dtype,
            )
            for i in range(n_layers)
        )
        self.linear = Linear(n_channels, 1, dtype=dtype)

    def forward(self, x, mask=None, gen=None):
        x = x.to(self.compute_dtype)
        for layer in self.conv:
            x = layer(x, gen)
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
    """Five convs (512 channels, kernel 5), each with BatchNorm and a fixed
    dropout of 0.5 (no config switches it off), tanh on all but the last
    (``layers.py:169-212``); the caller adds the residual. Batch statistics
    unless `use_running_average` (default: when `gen` is None)."""

    DROPOUT = 0.5

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

    def forward(self, x, gen=None, use_running_average=None):
        if use_running_average is None:
            use_running_average = gen is None
        x = x.to(self.compute_dtype).transpose(1, 2)  # [B, C, T]
        n = len(self.convolutions)
        for i, (conv, bn) in enumerate(self.convolutions):
            x = conv(x)
            x = bn(x.transpose(1, 2), use_running_average=use_running_average)
            if i < n - 1:
                x = torch.tanh(x)
            x = fast_dropout(x, self.DROPOUT, gen).transpose(1, 2)
        return x.transpose(1, 2)
