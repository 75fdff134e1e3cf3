"""Corpus statistics (a copy of the JAX package's ``preprocessing/stats.py``):
streaming mean, std, min and max of pitch and energy over their non-zero
values, and text-length statistics, saved as ``stats.json`` in the JAX
package's layout."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..type_definitions import Stats, StatsInfo


class StatsAccumulator:
    """Welford-style streaming scaler over non-zero values (zeros are the
    unvoiced and padding sentinels)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def update(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64)
        values = values[values != 0.0]
        if values.size == 0:
            return
        self.min = min(self.min, float(values.min()))
        self.max = max(self.max, float(values.max()))
        # Chan's parallel merge of this chunk into the running statistics
        chunk_mean = float(values.mean())
        chunk_n = values.size
        chunk_m2 = float(((values - chunk_mean) ** 2).sum())
        delta = chunk_mean - self.mean
        total = self.n + chunk_n
        self.mean += delta * chunk_n / total
        self.m2 += chunk_m2 + delta**2 * self.n * chunk_n / total
        self.n = total

    @property
    def std(self) -> float:
        return float(np.sqrt(self.m2 / self.n)) if self.n > 0 else 1.0

    def finalize(self) -> StatsInfo:
        std = self.std or 1.0
        mean = self.mean if self.n else 0.0
        mn = self.min if self.n else 0.0
        mx = self.max if self.n else 0.0
        return StatsInfo(min=mn, max=mx, std=std, mean=mean,
                         norm_min=(mn - mean) / std, norm_max=(mx - mean) / std)

    def normalize(self, values: np.ndarray) -> np.ndarray:
        """Z-normalized non-zero values; zeros stay zeros."""
        std = self.std or 1.0
        out = (values - self.mean) / std
        return np.where(values == 0.0, 0.0, out).astype(np.float32)


def save_stats(stats: Stats, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        json.dump(dataclasses.asdict(stats), f, indent=2)


def load_stats(path: Path) -> Stats:
    with open(path, "r", encoding="utf8") as f:
        return Stats.from_dict(json.load(f))
