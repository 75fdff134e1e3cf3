"""The operation counts: hand-computed values at small shapes, and the
plain reference's products as ``torch.utils.flop_counter`` counts them at a
small configuration."""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.common import acoustic, weights
from benchmark.common.vocoder import discriminator_rules, generator_rules
from benchmark.cost import flops
from benchmark.reference import fastspeech2 as ref
from benchmark.reference import hifigan as ref_voc
from benchmark.reference.numerics import Numerics

from ._tiny import tiny_cell


def test_hand_values():
    assert flops.conformer_layer(2, 2, 4, 3) == 8 * 2 * 2 * 4 + 14 * 2 * 4 + 4 * 4 * 2 + 2 * 2 * 2 * 3
    assert flops.predictor(3, 2, 4, 3, 2) == (2 * 3 * 2 * 3 + 2 * 3 * 2 * 4
                                              + 2 * 3 * 4 * 3 + 2 * 3 * 4 * 4 + 2 * 3 * 4)
    assert flops.postnet(1, 2, dim=3, k=1) == 2 * (2 * 3 + 3 * 9 + 3 * 2)
    fwd, bwd = flops.attention_bounds(1, 1, 4096, 128, [4096])
    assert math.isclose(fwd, 4 * 4096 ** 2 * 128 / 989e12)  # compute-bound at this size
    assert math.isclose(bwd, 10 * 4096 ** 2 * 128 / 989e12)
    fwd, _ = flops.attention_bounds(1, 1, 128, 128, [128])  # bytes-bound at this one
    assert math.isclose(fwd, (4 * 128 * 128 * 2 + 128 * 4 + 128 * 4) / 3.35e12)
    assert math.isclose(flops.mas_bound(1, 4, 2, [2], [4]), 4 * (8 + 8 + 2) / 3.35e12)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_acoustic_forward_against_the_flop_counter():
    cell = tiny_cell("synth.fs2-espnet-v1.b16")
    cfg = cell.config
    dev = torch.device("cpu")
    params = weights.make(acoustic.weight_rules(cfg), 1, dev)
    buffers = weights.make(acoustic.buffer_rules(cfg), 2, dev)
    model = ref.Model(params, cfg, Numerics("float32"), buffers)
    L, dur = 13, 5
    text = torch.randint(8, 30, (1, L))
    durations = torch.full((1, L), dur)
    T = L * dur
    got = _counted(lambda: model.forward_inference(text, torch.tensor([L]), durations, T,
                                                   acoustic.variance_bins(cfg, dev)))
    assert got == flops.acoustic_forward(cfg, L, T, train=False)


def test_vocoder_against_the_flop_counter():
    cfg = tiny_cell("train.hifigan-v1.b16-f32").config
    v, d = cfg["vocoder"], cfg["discriminators"]
    dev = torch.device("cpu")
    G = weights.make(generator_rules(v), 1, dev)
    D = weights.make(discriminator_rules(d), 2, dev)
    frames = 8
    got = _counted(lambda: ref_voc.generator(G, torch.randn(1, frames, v["n_mels"]), v,
                                             Numerics("float32")))
    assert got == flops.generator(v, frames)
    got = _counted(lambda: ref_voc.discriminators(D, torch.randn(2, frames * 256), d,
                                                  Numerics("float32")))
    assert got == flops.discriminators(d, 2, frames * 256)
