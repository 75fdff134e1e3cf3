"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit), and the least time a piece of work could take on it."""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, arithmetic: str) -> float:
    """The larger of operations over the arithmetic's peak and bytes over the
    memory's peak, in seconds."""
    return max(flops / PEAK_FLOPS[arithmetic], nbytes / PEAK_BYTES)
