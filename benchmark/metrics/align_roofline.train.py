"""Kernels B (``ops/mas.py``) and C (``ops/ctc.py``) in the traced steps:
the least time the alignment search and the forward-sum loss's two chains
and gradient need at each batch's lengths (``cost.flops.mas_bound``,
``ctc_bound``) over the device time of the kernels named below."""

from benchmark.cost.flops import ctc_bound, mas_bound

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
KERNELS = ("mas_width1", "ctc_chain", "ctc_grad")


def read(r):
    tr, batches = r.trace, r.records.get("traced_batches")
    if tr is None or not batches:
        return None
    seconds = tr.seconds(*KERNELS)
    if seconds <= 0:
        return None
    bound = 0.0
    for b in batches:
        B, L, T = b["shape"]
        bound += mas_bound(B, T, L, b["src_lens"], b["mel_lens"])
        bound += ctc_bound(B, T, L, b["mel_lens"])
    return 100.0 * bound / seconds
