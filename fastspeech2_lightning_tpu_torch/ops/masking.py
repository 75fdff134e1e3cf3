"""Length masks (counterpart of the JAX package's ``ops/masking.py``)."""

from __future__ import annotations

import torch


def mask_from_lens(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] boolean mask (True inside the sequence)."""
    ids = torch.arange(max_len, dtype=lens.dtype, device=lens.device)
    return ids[None, :] < lens[:, None]
