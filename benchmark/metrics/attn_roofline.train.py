"""Kernels A and A′ (``ops/attention.py``) in the traced steps: the least
time their work needs (``cost.flops.attention_bounds``: every Conformer
layer's forward and backward over the keys each item's mask needs) over
the device time of the kernels named below."""

from benchmark.cost.flops import attention_bounds

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
KERNELS = ("attention_fwd", "attention_bwd", "bwd_prepass", "kv_end_kernel")


def read(r):
    tr, batches = r.trace, r.records.get("traced_batches")
    if tr is None or not batches:
        return None
    seconds = tr.seconds(*KERNELS)
    if seconds <= 0:
        return None
    m = r.config["model"]
    bound = 0.0
    for b in batches:
        B, L, T = b["shape"]
        for part, n, keys in (("encoder", L, b["src_lens"]), ("decoder", T, b["mel_lens"])):
            c = m[part]
            fwd, bwd = attention_bounds(B, c["heads"], n, c["input_dim"] // c["heads"],
                                        [int(k) for k in keys])
            bound += c["layers"] * (fwd + bwd)
    return 100.0 * bound / seconds
