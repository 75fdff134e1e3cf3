"""The configuration fields the serving and training paths read, as plain
dataclasses.

A copy of what the port needs of the JAX package's ``config/__init__.py``
(model, preprocessing, text and training), with the same defaults
(``config/__init__.py:85-440``). ``from_dict`` reads the JSON config dict a
checkpoint stores (``config.model_checkpoint_dump()``) and ignores every field
the port does not read, so a full config loads unchanged. ``from_file``
reads a config file as the JAX CLI does (``:483-535``): JSON only (this
package does not read YAML; the JAX CLI reads the same JSON file), partial
files merged, relative paths resolved against the file's folder."""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union


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
    save_dir: str = "./preprocessed"


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
class NoamOptimizerConfig(_FromDict):
    learning_rate: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 1e-6
    warmup_steps: int = 1000


@dataclasses.dataclass
class LoggerConfig(_FromDict):
    name: str = "BaseExperiment"
    save_dir: str = "./logs_and_checkpoints"
    version: str = "base"


@dataclasses.dataclass
class TrainingConfig(_FromDict):
    batch_size: int = 16
    bucket_count: int = 4
    seed: int = 0
    max_steps: int = 100000
    max_epochs: int = 1000
    use_weighted_sampler: bool = False
    optimizer: NoamOptimizerConfig = dataclasses.field(default_factory=NoamOptimizerConfig)
    mel_loss_weight: float = 1.0
    postnet_loss_weight: float = 1.0
    pitch_loss_weight: float = 0.1
    energy_loss_weight: float = 0.1
    duration_loss_weight: float = 0.1
    attn_ctc_loss_weight: float = 0.1
    attn_bin_loss_weight: float = 0.1
    attn_bin_loss_warmup_epochs: int = 100
    gradient_clip_val: float = 1.0
    ema_decay: float = 0.0
    freeze_components: List[str] = dataclasses.field(default_factory=list)
    halt_on_non_finite: bool = True
    training_filelist: str = "./preprocessed/training_filelist.psv"
    validation_filelist: str = "./preprocessed/validation_filelist.psv"
    logger: LoggerConfig = dataclasses.field(default_factory=LoggerConfig)

    def __post_init__(self):
        if self.attn_bin_loss_warmup_epochs < 1:
            raise ValueError("training.attn_bin_loss_warmup_epochs must be >= 1")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("training.ema_decay must lie in [0, 1)")


_PARTIAL_KEYS = ("model", "training", "preprocessing", "text")


def _read_json(path: Path) -> dict:
    if path.suffix in (".yaml", ".yml"):
        raise ValueError(
            f"{path}: this package reads JSON configs only; write the config as "
            "JSON (the JAX package's CLI reads the same .json file)"
        )
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    return json.loads(path.read_text(encoding="utf8"))


def _relative_to(base: Path, value: Optional[str]) -> Optional[str]:
    if value is None or Path(value).is_absolute():
        return value
    return str((base / value).resolve())


@dataclasses.dataclass
class FastSpeech2Config(_FromDict):
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    preprocessing: PreprocessingConfig = dataclasses.field(
        default_factory=PreprocessingConfig
    )
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "FastSpeech2Config":
        """Read a JSON config file: ``path_to_<key>_config_file`` partials are
        the base that the file's inline section overrides
        (``load_partials``, ``config/__init__.py:507-535``), and the relative
        data, log and filelist paths resolve against the file's folder
        (``:483-494``)."""
        path = Path(path)
        data = _read_json(path)
        for key in _PARTIAL_KEYS:
            rel = data.get(f"path_to_{key}_config_file")
            if not rel:
                continue
            partial_path = Path(rel)
            if not partial_path.is_absolute():
                partial_path = (path.parent / partial_path).resolve()
            merged = _read_json(partial_path)
            if isinstance(data.get(key), dict):
                merged.update(data[key])
            data[key] = merged
        config = cls.from_dict(data)
        base = path.parent
        config.preprocessing.save_dir = _relative_to(base, config.preprocessing.save_dir)
        t = config.training
        t.training_filelist = _relative_to(base, t.training_filelist)
        t.validation_filelist = _relative_to(base, t.validation_filelist)
        t.logger.save_dir = _relative_to(base, t.logger.save_dir)
        return config
