"""Shared types: the synthesis output formats and the corpus statistics
carried in a checkpoint (copies of the JAX package's
``type_definitions.SynthesizeOutputFormats``, ``Stats`` and ``StatsInfo``,
the latter two as plain dataclasses)."""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional


class SynthesizeOutputFormats(str, Enum):
    """Output formats of the ``synthesize`` command."""

    wav = "wav"
    spec = "spec"
    textgrid = "textgrid"
    readalong_xml = "readalong-xml"
    readalong_html = "readalong-html"


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
