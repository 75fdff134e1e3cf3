"""Seeded weights made on the device in a few large calls.

A rule per tensor says its distribution: ``("normal", mean, std)``,
``("uniform", lo, hi)``, ``("values", array)`` or ``("smooth", std, K)``: a
table whose rows vary smoothly with the row index (K cosines of the index
with normal coefficients), as a trained table of binned values does. ``make`` draws every
normal tensor's elements from one ``torch.randn`` call and every uniform's
from one ``torch.rand`` call of a ``torch.Generator`` on `device` seeded
with `seed`, then splits and scales them; the same seed gives the same
tensors on the same kind of device."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

Rule = Tuple


def make(rules: Dict[str, Tuple[tuple, Rule]], seed: int, device, dtype=torch.float32
         ) -> Dict[str, torch.Tensor]:
    """{name: (shape, rule)} -> {name: tensor} on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    kinds = {"normal": [], "uniform": []}
    for name, (shape, rule) in rules.items():
        if rule[0] in kinds:
            kinds[rule[0]].append((name, shape, rule))
    out: Dict[str, torch.Tensor] = {}
    for kind, items in kinds.items():
        total = sum(math.prod(shape) for _, shape, _ in items)
        if not total:
            continue
        draw = torch.randn if kind == "normal" else torch.rand
        flat = draw(total, generator=gen, device=device, dtype=torch.float32)
        pos = 0
        for name, shape, rule in items:
            n = math.prod(shape)
            x = flat[pos:pos + n].view(shape)
            pos += n
            a, b = rule[1], rule[2]
            out[name] = (a + b * x if kind == "normal" else a + (b - a) * x).to(dtype)
    for name, (shape, rule) in rules.items():
        if rule[0] == "smooth":
            n, dim = shape
            k = torch.arange(rule[2], device=device, dtype=torch.float32)
            rows = torch.arange(n, device=device, dtype=torch.float32) + 0.5
            basis = torch.cos(math.pi * rows[:, None] * k[None, :] / n)
            coef = torch.randn(rule[2], dim, generator=gen, device=device)
            out[name] = (basis @ coef * (rule[1] / math.sqrt(rule[2]))).to(dtype)
    for name, (shape, rule) in rules.items():
        if rule[0] == "values":
            out[name] = torch.as_tensor(np.asarray(rule[1]), dtype=dtype,
                                        device=device).reshape(shape)
    return {name: out[name] for name in rules}


def fan_in_normal(shape: tuple, gain: float = 1.0) -> Rule:
    """N(0, gain / fan_in): fan_in = every axis but the first."""
    fan = math.prod(shape[1:]) if len(shape) > 1 else 1
    return ("normal", 0.0, math.sqrt(gain / fan))
