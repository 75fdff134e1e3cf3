"""Corpus statistics carried in a checkpoint (copy of the JAX package's
``type_definitions.Stats``/``StatsInfo`` as plain dataclasses)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class StatsInfo:
    min: float
    max: float
    std: float
    mean: float
    norm_min: float
    norm_max: float

    @classmethod
    def from_dict(cls, d: dict) -> "StatsInfo":
        return cls(**{f.name: float(d[f.name]) for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class Stats:
    pitch: StatsInfo
    energy: StatsInfo
    character_length: Optional[StatsInfo] = None
    phone_length: Optional[StatsInfo] = None
    arpabet_length: Optional[StatsInfo] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Stats":
        return cls(
            **{
                f.name: StatsInfo.from_dict(d[f.name])
                for f in dataclasses.fields(cls)
                if d.get(f.name) is not None
            }
        )
