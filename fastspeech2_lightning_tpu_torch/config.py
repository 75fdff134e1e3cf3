"""The configuration fields the serving path reads, as plain dataclasses.

A copy of what this slice needs of the JAX package's ``config/__init__.py``
(model, preprocessing.audio and text), with the same defaults
(``config/__init__.py:85-266``). ``from_dict`` reads the JSON config dict a
checkpoint stores (``config.model_checkpoint_dump()``) and ignores every field
the slice does not read, so a full training config loads unchanged."""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, Optional


def _from_dict(cls, data: Optional[dict]):
    """Build dataclass `cls` from `data`, recursing into dataclass fields and
    ignoring keys that are not fields."""
    data = data or {}
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = hints[f.name]
        if dataclasses.is_dataclass(ftype):
            value = _from_dict(ftype, value)
        kwargs[f.name] = value
    return cls(**kwargs)


class _FromDict:
    @classmethod
    def from_dict(cls, data: Optional[dict]):
        return _from_dict(cls, data)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# text representation levels (TargetTrainingTextRepresentationLevel values)
CHARACTERS = "characters"
PHONES = "phones"


@dataclasses.dataclass
class ConformerConfig(_FromDict):
    layers: int = 4
    heads: int = 2
    input_dim: int = 256
    feedforward_dim: int = 1024
    conv_kernel_size: int = 9
    dropout: float = 0.2
    attention_dropout: Optional[float] = None


@dataclasses.dataclass
class VariancePredictorConfig(_FromDict):
    loss: str = "mse"
    n_layers: int = 5
    kernel_size: int = 3
    dropout: float = 0.5
    input_dim: int = 256
    n_bins: int = 256
    depthwise: bool = True
    level: str = "phone"  # "phone" or "frame"; the duration predictor ignores it


@dataclasses.dataclass
class VariancePredictors(_FromDict):
    energy: VariancePredictorConfig = dataclasses.field(
        default_factory=VariancePredictorConfig
    )
    duration: VariancePredictorConfig = dataclasses.field(
        default_factory=VariancePredictorConfig
    )
    pitch: VariancePredictorConfig = dataclasses.field(
        default_factory=VariancePredictorConfig
    )


@dataclasses.dataclass
class ModelConfig(_FromDict):
    encoder: ConformerConfig = dataclasses.field(default_factory=ConformerConfig)
    decoder: ConformerConfig = dataclasses.field(default_factory=ConformerConfig)
    variance_predictors: VariancePredictors = dataclasses.field(
        default_factory=VariancePredictors
    )
    target_text_representation_level: str = CHARACTERS
    learn_alignment: bool = True
    use_global_style_token_module: bool = False
    max_length: int = 1000
    mel_loss: str = "mse"
    use_postnet: bool = True
    multilingual: bool = False
    multispeaker: bool = False
    max_mel_length: int = 2048
    dtype: str = "bfloat16"  # compute dtype; parameters stay float32


@dataclasses.dataclass
class AudioConfig(_FromDict):
    min_audio_length: float = 0.4
    max_audio_length: float = 11.0
    max_wav_value: float = 32767.0
    input_sampling_rate: int = 22050
    output_sampling_rate: int = 22050
    alignment_sampling_rate: int = 22050
    target_bit_depth: int = 16
    n_fft: int = 1024
    fft_window_size: int = 1024
    fft_hop_size: int = 256
    f_min: int = 0
    f_max: int = 8000
    n_mels: int = 80
    spec_type: str = "mel-librosa"
    vocoder_segment_size: int = 8192


@dataclasses.dataclass
class PreprocessingConfig(_FromDict):
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)


@dataclasses.dataclass
class TextConfig(_FromDict):
    split_text: bool = True
    boundaries: Dict[str, Any] = dataclasses.field(default_factory=dict)
    symbols: Dict[str, Any] = dataclasses.field(default_factory=dict)
    to_replace: Dict[str, str] = dataclasses.field(default_factory=dict)
    cleaners: List[str] = dataclasses.field(
        default_factory=lambda: ["lower", "collapse_whitespace", "nfc_normalize"]
    )
    g2p_engines: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # accept everyvoice-style dotted callables, e.g. "everyvoice.utils.lower"
        self.cleaners = [
            c.rsplit(".", 1)[-1] if isinstance(c, str) else c for c in self.cleaners
        ]


@dataclasses.dataclass
class FastSpeech2Config(_FromDict):
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    preprocessing: PreprocessingConfig = dataclasses.field(
        default_factory=PreprocessingConfig
    )
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
