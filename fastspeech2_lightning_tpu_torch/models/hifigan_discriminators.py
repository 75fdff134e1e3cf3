"""HiFiGAN discriminators, multi-period and multi-scale (counterpart of the
JAX package's ``models/hifigan_discriminators.py``).

Five period sub-discriminators (periods 2, 3, 5, 7, 11: Conv2d stacks over
the [T/p, p] fold of the waveform) and three scale sub-discriminators (the
raw waveform and its 2x and 4x average-pooled copies: grouped Conv1d
stacks). Every conv is weight-normed with explicit parameters, ``v``, ``g``
and ``b``: w = g * v / sqrt(sum(v^2) + 1e-12), the sum over every axis but
the output channels (torch's ``weight_norm`` at dim 0), the raw-scale MSD
included, where the reference puts spectral norm.

Layouts are torch's: a conv's ``v`` is [Cout, Cin/groups, K] (Conv1d) or
[Cout, Cin, KH, KW] (Conv2d), ``g`` [Cout, 1, ...]; activations are
[B, C, T] and [B, C, T/p, p]; feature maps come back in those layouts (the
JAX package's are channels-last). ``discriminators_from_jax`` in
``convert.py`` maps a JAX parameter tree onto these modules' state_dict.

The forward runs in the dtype of the waveform it is given: each parameter is
cast to it *before* the weight norm, as the JAX trainer casts its parameter
tree, so in bf16 the norm itself is computed in bf16 and the gradients
reach the f32 parameters through the cast."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


@dataclasses.dataclass
class DiscriminatorConfig:
    """The JAX package's ``DiscriminatorConfig``, all fields.
    ``msd_phase_packed`` and ``msd_block_diag`` choose how XLA executes the
    MSD's grouped convs on the TPU's lanes (a phase-packed widened kernel, a
    block-diagonal dense kernel); both compute the same function as the
    plain grouped conv, which is what ``F.conv1d(groups=g)`` runs here, so
    they are read and do nothing."""

    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    mpd_channels: Tuple[int, ...] = (32, 128, 512, 1024, 1024)
    msd_channels: Tuple[int, ...] = (128, 128, 256, 512, 1024, 1024, 1024)
    msd_groups: Tuple[int, ...] = (1, 4, 16, 16, 16, 16, 1)
    msd_strides: Tuple[int, ...] = (1, 2, 2, 4, 4, 1, 1)
    msd_kernels: Tuple[int, ...] = (15, 41, 41, 41, 41, 41, 5)
    n_scales: int = 3
    msd_phase_packed: bool = True
    msd_block_diag: bool = True


class WNConv(nn.Module):
    """A weight-normed conv's parameters: ``v`` [Cout, Cin/groups, *kernel],
    ``g`` [Cout, 1, ...] (initialised to the norm of ``v``, so the initial
    weight is ``v``) and ``b`` [Cout]."""

    def __init__(self, cout: int, cin: int, kernel: Sequence[int], generator: torch.Generator,
                 device=None, scale: float = 0.02):
        super().__init__()
        v = torch.randn((cout, cin, *kernel), generator=generator) * scale
        self.v = nn.Parameter(v.to(device))
        self.g = nn.Parameter(_norm(v).to(device))
        self.b = nn.Parameter(torch.zeros(cout, device=device))

    def weight(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w, b) in `dtype`: the parameters cast first, then the norm."""
        v, g = self.v.to(dtype), self.g.to(dtype)
        return g * v / _norm(v), self.b.to(dtype)


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` with the derivative 1 at exactly 0, as JAX's
    ``leaky_relu`` (``where(x >= 0, x, slope * x)``) has it; torch's takes
    the slope there. Exact zeros are common in a discriminator: a crop's
    zero padding gives all-zero windows, whose pre-activations are the
    biases, 0 at initialisation."""

    @staticmethod
    def forward(ctx, x):
        y = F.leaky_relu(x, LRELU_SLOPE)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return torch.where(y >= 0, grad, grad * LRELU_SLOPE)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return _LeakyReLU.apply(x) if torch.is_grad_enabled() and x.requires_grad else (
        F.leaky_relu(x, LRELU_SLOPE))


def _norm(v: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, v.ndim))
    return torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)


def _conv1d(x: torch.Tensor, conv: WNConv, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """x [B, Cin, T] -> [B, Cout, T'], (k - 1) // 2 zeros on both sides."""
    w, b = conv.weight(x.dtype)
    return F.conv1d(x, w, b, stride=stride, padding=(w.shape[-1] - 1) // 2, groups=groups)


def _conv2d(x: torch.Tensor, conv: WNConv, stride: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """x [B, Cin, H, W] -> [B, Cout, H', W'], (k - 1) // 2 zeros on each
    side of each axis (the MPD's kernels are (k, 1): H only)."""
    w, b = conv.weight(x.dtype)
    kh, kw = w.shape[-2], w.shape[-1]
    return F.conv2d(x, w, b, stride=stride, padding=((kh - 1) // 2, (kw - 1) // 2))


class PeriodDiscriminator(nn.Module):
    """One MPD sub-discriminator: (5, 1) convs with stride 3 on H but the
    last, then a (3, 1) post conv to one channel."""

    def __init__(self, config: DiscriminatorConfig, generator, device=None):
        super().__init__()
        layers, cin = [], 1
        for cout in config.mpd_channels:
            layers.append(WNConv(cout, cin, (5, 1), generator, device))
            cin = cout
        self.layers = nn.ModuleList(layers)
        self.post = WNConv(1, cin, (3, 1), generator, device)

    def forward(self, wav: torch.Tensor, period: int):
        """wav [B, T] -> (score [B, N], features): T reflect-padded at the
        end to a multiple of the period (``:256-272``)."""
        B, T = wav.shape
        pad = (-T) % period
        if pad:
            wav = F.pad(wav[:, None], (0, pad), mode="reflect")[:, 0]
        x = wav.reshape(B, 1, -1, period)
        feats = []
        n = len(self.layers)
        for j, conv in enumerate(self.layers):
            x = leaky_relu(_conv2d(x, conv, stride=(3 if j < n - 1 else 1, 1)))
            feats.append(x)
        x = _conv2d(x, self.post)
        feats.append(x)
        return x.reshape(B, -1), feats


def msd_groups(config: DiscriminatorConfig, j: int, cin: int) -> int:
    """The groups of MSD conv `j`: the configured count where it divides
    both channel counts, else 1 (``_msd_groups``, ``:320-324``)."""
    grp = config.msd_groups[j]
    return grp if cin % grp == 0 and config.msd_channels[j] % grp == 0 else 1


class ScaleDiscriminator(nn.Module):
    """One MSD sub-discriminator: grouped strided convs, then a k = 3 post
    conv to one channel."""

    def __init__(self, config: DiscriminatorConfig, generator, device=None):
        super().__init__()
        self.config = config
        layers, cin = [], 1
        for j, (cout, kern) in enumerate(zip(config.msd_channels, config.msd_kernels)):
            layers.append(WNConv(cout, cin // msd_groups(config, j, cin), (kern,), generator,
                                 device))
            cin = cout
        self.layers = nn.ModuleList(layers)
        self.post = WNConv(1, cin, (3,), generator, device)

    def forward(self, wav: torch.Tensor):
        """wav [B, T] -> (score [B, T'], features) (``_msd_sub``, ``:327-342``)."""
        x = wav[:, None]
        feats, cin = [], 1
        for j, conv in enumerate(self.layers):
            x = _conv1d(x, conv, stride=self.config.msd_strides[j],
                        groups=msd_groups(self.config, j, cin))
            x = leaky_relu(x)
            feats.append(x)
            cin = self.config.msd_channels[j]
        x = _conv1d(x, self.post)
        feats.append(x)
        return x.reshape(x.shape[0], -1), feats


def avg_pool1d(x: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, T // 2 + 1]: torch's AvgPool1d(4, 2, padding=2), the
    zero padding counted (``_avg_pool1d``, ``:311-317``)."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class Discriminators(nn.Module):
    """MPD and MSD. Parameters are drawn from ``torch.Generator`` seeded
    with `seed` (v ~ N(0, 0.02^2), g = |v|, b = 0, the JAX package's
    distributions; its draws come from ``jax.random`` and are not
    reproduced: weights cross over through ``discriminators_from_jax``)."""

    def __init__(self, config: DiscriminatorConfig, seed: int = 0, device=None):
        super().__init__()
        self.config = config
        gen = torch.Generator().manual_seed(seed)
        self.mpd = nn.ModuleList(PeriodDiscriminator(config, gen, device)
                                 for _ in config.periods)
        self.msd = nn.ModuleList(ScaleDiscriminator(config, gen, device)
                                 for _ in range(config.n_scales))

    def forward(self, wav: torch.Tensor):
        return discriminator_forward(self, wav)


def discriminator_forward(disc: Discriminators, wav: torch.Tensor
                          ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
    """wav [B, T] -> (scores, features) of every sub-discriminator, MPD's
    first, then MSD's, in wav's dtype."""
    scores, feats = [], []
    for sub, period in zip(disc.mpd, disc.config.periods):
        s, f = sub(wav, period)
        scores.append(s)
        feats.append(f)
    x = wav
    for i, sub in enumerate(disc.msd):
        if i > 0:
            x = avg_pool1d(x)
        s, f = sub(x)
        scores.append(s)
        feats.append(f)
    return scores, feats


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
