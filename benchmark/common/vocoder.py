"""The vocoder's and discriminators' seeded weight rules."""

from __future__ import annotations

import numpy as np

from ..reference.hifigan import discriminator_spec, generator_spec


def generator_rules(v: dict) -> dict:
    """Fan-in scaled normals (gain 0.5 for the convs, 2u for an upsampling
    transposed conv, whose fan-in is its input channels times its taps) and
    zero biases."""
    out = {}
    for name, (shape, kind) in generator_spec(v).items():
        if kind == "bias":
            out[name] = (shape, ("normal", 0.0, 0.0))
        else:
            cin, taps = (shape[0] if kind == "up" else shape[1]), shape[2]
            gain = 2.0 * v["upsample_rates"][int(name.split(".")[1])] if kind == "up" else 0.5
            out[name] = (shape, ("normal", 0.0, float(np.sqrt(gain / (cin * taps)))))
    return out


def discriminator_rules(d: dict) -> dict:
    """v ~ N(0, 0.02^2), g = 0.02 sqrt(fan-in) (about the norm of v), b = 0."""
    spec = discriminator_spec(d)
    out = {}
    for name, shape in spec.items():
        if name.endswith(".v"):
            out[name] = (shape, ("normal", 0.0, 0.02))
        elif name.endswith(".g"):
            fan = int(np.prod(spec[name[:-1] + "v"][1:]))
            out[name] = (shape, ("normal", 0.02 * float(np.sqrt(fan)), 0.0))
        else:
            out[name] = (shape, ("normal", 0.0, 0.0))
    return out
