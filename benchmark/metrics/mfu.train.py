"""The training step's share of the card's bf16 peak: the model operations
of the window's steps, counted on each item's real symbols and frames
(``cost.flops.acoustic_train_step``), over the window, over 989 TFLOP/s."""

from benchmark.cost.flops import acoustic_train_step
from benchmark.cost.peaks import PEAK_FLOPS

UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_frames_per_s"


def read(r):
    items = r.records.get("items")
    if not items:
        return None
    flops = sum(acoustic_train_step(r.config, step) for step in items)
    return 100.0 * flops / r.window_s / PEAK_FLOPS["bfloat16"]
