"""Bucketized variance lookup (counterpart of the JAX package's
``ops/variance.py::bucketize``)."""

from __future__ import annotations

import torch


def bucketize(values: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """The count of boundaries strictly below each value, i.e. the bucket i
    with b[i-1] < v <= b[i]; a value equal to a boundary falls in the lower
    bucket. The boundaries must be the checkpoint's own ``*_bins`` buffers:
    two linspace implementations differ in the last ulp, which moves values
    that sit on a boundary."""
    return torch.bucketize(values, boundaries.to(values.dtype), right=False)
