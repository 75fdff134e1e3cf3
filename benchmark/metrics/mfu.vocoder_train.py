"""The vocoder training step's share of TF32's peak (cuDNN runs the f32
convs in TF32, PyTorch's default for them): the analytic generator and
discriminator work of the window's steps (``cost.flops.vocoder_train_step``)
over the window, over 495 TFLOP/s."""

from benchmark.cost.flops import vocoder_train_step
from benchmark.cost.peaks import PEAK_FLOPS

UNIT = "%"
SOURCE = "host_clock"
MOVES = "vocoder_train_samples_per_s"


def read(r):
    steps = r.counters.get("steps")
    if not steps:
        return None
    hop = 1
    for u in r.config["vocoder"]["upsample_rates"]:
        hop *= u
    flops = steps * vocoder_train_step(r.config["vocoder"], r.config["discriminators"],
                                       r.counters["batch"], r.counters["frames"], hop)
    return 100.0 * flops / r.window_s / PEAK_FLOPS["tf32"]
