"""Length regulation: expand phone-rate features to frame rate
(counterpart of the JAX package's ``ops/length_regulator.py``)."""

from __future__ import annotations

import torch


def length_regulate(
    x: torch.Tensor, durations: torch.Tensor, max_length: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand x [B, L, D] by integer durations [B, L] into [B, max_length, D].

    Returns (expanded, mask [B, max_length] bool, mel_lens [B] int32). A total
    duration longer than max_length is truncated: mel_lens = min(total,
    max_length), and frames past mel_lens are zero."""
    durations = durations.to(torch.int64)
    ends = torch.cumsum(durations, dim=1)  # [B, L]
    mel_lens = torch.clamp(ends[:, -1], max=max_length).to(torch.int32)
    frame_ids = torch.arange(max_length, dtype=torch.int64, device=x.device)
    # phone index of each frame = number of phone ends <= frame id
    phone_idx = torch.searchsorted(
        ends, frame_ids.expand(ends.shape[0], -1).contiguous(), right=True
    )
    phone_idx = torch.clamp(phone_idx, max=x.shape[1] - 1)
    expanded = torch.gather(
        x, 1, phone_idx[:, :, None].expand(-1, -1, x.shape[2])
    )
    mask = frame_ids[None, :] < mel_lens[:, None]
    expanded = expanded * mask[:, :, None].to(x.dtype)
    return expanded, mask, mel_lens
