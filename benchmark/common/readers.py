"""Readers that several per-layer metrics share: each metric file names its
unit, source and the end-to-end metric it moves, and takes one of these as
its ``read``. A reader returns None where the run gave it nothing to read."""

from __future__ import annotations

from benchmark.cost.flops import mrf_stage_bound, served_least_seconds

MRF_KERNELS = ("mrf_conv", "mrf_stage")


def idle(r):
    """The share of the traced window in which no device operation ran, %."""
    tr = r.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def memory_peak_gib(r):
    """The process's peak of allocated device memory over set-up and the
    window, GiB (``torch.cuda.max_memory_allocated``)."""
    peak = r.counters.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None


def served_mfu(r):
    """The served model's share of the card's peaks, %: the least time the
    window's work could take (``cost.flops.served_least_seconds``: every real
    row's forward at the bf16 peak, its vocoder at TF32's) over the window."""
    work = r.records.get("work")
    if not work:
        return None
    return 100.0 * served_least_seconds(r.config, work) / r.window_s


def mrf_roofline(r):
    """The MRF kernels (``ops/vocoder_resblocks.py``) in the traced vocoder
    calls, %: the least time each fused stage needs
    (``cost.flops.mrf_stage_bound``, the V1 stages at C 128, 64, 32) over the
    device time of the kernels in ``MRF_KERNELS``."""
    tr, calls = r.trace, r.records.get("traced")
    if tr is None or not calls:
        return None
    seconds = tr.seconds(*MRF_KERNELS)
    if seconds <= 0:
        return None
    v = r.config["vocoder"]
    ks, n_dil = v["resblock_kernel_sizes"], len(v["resblock_dilation_sizes"][0])
    bound = 0.0
    for c in calls:
        B, T, _ = c["vocoder_in"]
        ch = v["upsample_initial_channel"]
        for u in v["upsample_rates"]:
            ch //= 2
            T *= u
            if ch <= 128:
                wbytes = 4.0 * ch * ch * 2 * sum(ks) * n_dil
                bound += mrf_stage_bound(B, T, ch, ks, n_dil, wbytes)
    return 100.0 * bound / seconds
