"""Variance-adaptor ops: bucketized lookup and phone-level averaging
(counterpart of the JAX package's ``ops/variance.py``)."""

from __future__ import annotations

import torch


def bucketize(values: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """The count of boundaries strictly below each value, i.e. the bucket i
    with b[i-1] < v <= b[i]; a value equal to a boundary falls in the lower
    bucket. The boundaries must be the checkpoint's own ``*_bins`` buffers:
    two linspace implementations differ in the last ulp, which moves values
    that sit on a boundary."""
    return torch.bucketize(values, boundaries.to(values.dtype), right=False)


def average_variance(var: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Average a frame-level variance signal [B, T] over each phone's frames
    (durations [B, L]) -> [B, L]: the mean of the phone's NONZERO frames,
    0 where it has none (``ops/variance.py:12-38``: cumulative sums, span
    differences)."""
    durs = durs.to(torch.int64)
    T = var.shape[1]
    ends = torch.clamp(torch.cumsum(durs, dim=1), 0, T)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    zero = torch.zeros_like(var[:, :1])
    cums = torch.cat([zero, torch.cumsum(var, dim=1)], dim=1)
    cums_n = torch.cat([zero, torch.cumsum((var != 0.0).to(var.dtype), dim=1)], dim=1)
    sums = cums.gather(1, ends) - cums.gather(1, starts)
    nelems = cums_n.gather(1, ends) - cums_n.gather(1, starts)
    return torch.where(nelems == 0.0, 0.0, sums / torch.clamp(nelems, min=1.0))
