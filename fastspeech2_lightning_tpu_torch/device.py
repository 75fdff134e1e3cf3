"""Device resolution for the port's entry points.

Entry points run on the card. The CPU is used only when the caller asks for
it by name (the tests do); a missing card is an error, never a silent move to
the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None or "cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU; "cuda:N" -> that card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this entry point runs on the GPU "
            "unless called with device='cpu'"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
