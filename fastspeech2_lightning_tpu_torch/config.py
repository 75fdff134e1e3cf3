"""The configuration fields the serving and training paths read, as plain
dataclasses.

A copy of what the port needs of the JAX package's ``config/__init__.py``
(model, preprocessing, text and training), with the same defaults
(``config/__init__.py:85-440``). ``from_dict`` reads the JSON config dict a
checkpoint stores (``config.model_checkpoint_dump()``) and ignores every field
the port does not read, so a full config loads unchanged. ``from_file``
reads a config file as the JAX CLI does (``:483-535``): JSON when its suffix
is ``.json``, YAML otherwise (``yaml_reader.safe_load``, which reads what
``yaml.safe_load`` reads, without ``yaml``), partial files merged, relative
paths resolved against the file's folder. ``load_config_base_command`` adds
the CLI's ``-c key.path=value`` overrides (``:626-663``), each value read as
YAML, or kept as the raw string where YAML refuses it, as in JAX."""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from .yaml_reader import YAMLError, safe_load


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
        elif typing.get_origin(ftype) is list and value is not None:
            (item_type,) = typing.get_args(ftype) or (None,)
            if dataclasses.is_dataclass(item_type):
                value = [_from_dict(item_type, v) for v in value]
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
PHONOLOGICAL_FEATURES = "phonological_features"


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
class DatasetSource(_FromDict):
    """One corpus of wavs (``config/__init__.py:110-116``): `data_dir`
    holds ``<basename>.wav`` for every row of `filelist`; `sox_effects`
    (``[["channels", "1"], ["rate", "22050"], ...]``) apply on loading."""

    label: str = "dataset_0"
    data_dir: str = "."
    filelist: str = "filelist.psv"
    filelist_loader: str = "psv"
    permissions_obtained: bool = False
    sox_effects: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PreprocessingConfig(_FromDict):
    dataset: str = "YourDataSet"
    dataset_split_seed: int = 1234
    train_split: float = 0.9
    save_dir: str = "./preprocessed"
    cpus: Optional[int] = None  # worker processes
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    source_data: List[DatasetSource] = dataclasses.field(default_factory=list)


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


EARLY_STOPPING_METRICS = ("none", "mae", "js")


@dataclasses.dataclass
class EarlyStoppingConfig(_FromDict):
    metric: str = "none"  # any value but "none" stops on validation/total_loss
    patience: int = 4


@dataclasses.dataclass
class TrainingConfig(_FromDict):
    """The JAX package's training section (``config/__init__.py:312-441``).
    Like every key the port does not read, ``steps_per_call`` and
    ``prng_impl`` (the JAX trainer's dispatch and random-number generator;
    the port runs one step a call and torch generators) are ignored.
    ``fused_optimizer`` runs AdamW over one flat parameter vector whose
    moments are split over the data ranks (ZeRO-1, ``training/state.py``
    ``ZeroAdamWNoam``); under tensor parallelism the trainer keeps
    per-parameter moments, as the JAX trainer does.
    ``vocoder_path`` is the HiFiGAN checkpoint that vocodes the validation
    audio (``training/loop.py``), relative to the config file's folder."""

    batch_size: int = 16
    save_top_k_ckpts: int = 5
    ckpt_steps: Optional[int] = None
    ckpt_epochs: Optional[int] = 1
    val_check_interval: Optional[Union[int, float]] = 500  # float: a fraction of an epoch
    prefetch_batches: int = 2
    async_checkpoint: bool = False
    fused_optimizer: bool = False
    finetune_checkpoint: Optional[str] = None
    early_stopping: EarlyStoppingConfig = dataclasses.field(default_factory=EarlyStoppingConfig)
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
    vocoder_path: Optional[str] = None
    logger: LoggerConfig = dataclasses.field(default_factory=LoggerConfig)

    def __post_init__(self):
        if self.attn_bin_loss_warmup_epochs < 1:
            raise ValueError("training.attn_bin_loss_warmup_epochs must be >= 1")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("training.ema_decay must lie in [0, 1)")
        if self.early_stopping.metric not in EARLY_STOPPING_METRICS:
            raise ValueError(f"training.early_stopping.metric must be one of "
                             f"{EARLY_STOPPING_METRICS}, not {self.early_stopping.metric!r}")


_PARTIAL_KEYS = ("model", "training", "preprocessing", "text")


def _read_config_file(path: Path) -> dict:
    """A config file as the JAX CLI reads it (``config/__init__.py:497-504``):
    JSON when its suffix is ``.json``, YAML otherwise (``.yaml``, ``.yml``,
    ``.conf`` or none), an empty YAML file as ``{}``."""
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    text = path.read_text(encoding="utf8")
    if path.suffix == ".json":
        return json.loads(text)
    return safe_load(text) or {}


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

    def __post_init__(self):
        """Phone-level and phonological-feature models get the bundled
        g2p's IPA inventory as the symbol set ``g2p_ipa`` when the config
        declares none of that name: the phones its symbols lack, in
        ``IPA_PHONES`` order (``config/__init__.py:572-591``). Character
        models keep their symbols."""
        if self.model.target_text_representation_level == CHARACTERS:
            return
        symbols = self.text.symbols
        if "g2p_ipa" in symbols:
            return
        from .text.g2p import IPA_PHONES

        declared = set()
        for key, val in symbols.items():
            if key != "pad":
                declared.update([val] if isinstance(val, str) else val)
        missing = [p for p in IPA_PHONES if p not in declared]
        if missing:
            self.text.symbols = {**symbols, "g2p_ipa": missing}  # the caller's dict stays

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "FastSpeech2Config":
        """Read a config file (JSON or YAML, as ``_read_config_file`` says):
        ``path_to_<key>_config_file`` partials are the base that the file's
        inline section overrides (``load_partials``,
        ``config/__init__.py:507-535``), and the relative ``save_dir``,
        training filelists, log directory and ``vocoder_path`` resolve
        against the file's folder (``:483-494``); ``source_data``'s
        ``data_dir`` and ``filelist`` stay as written, relative to the
        working directory."""
        return load_config_base_command(path)

    @classmethod
    def _from_raw(cls, data: dict, path: Path) -> "FastSpeech2Config":
        config = cls.from_dict(data)
        base = path.parent
        p = config.preprocessing
        p.save_dir = _relative_to(base, p.save_dir)
        # source_data's data_dir and filelist stay as written: the JAX
        # DatasetSource has no validator for them, so a relative one is read
        # from the working directory
        t = config.training
        t.training_filelist = _relative_to(base, t.training_filelist)
        t.validation_filelist = _relative_to(base, t.validation_filelist)
        t.vocoder_path = _relative_to(base, t.vocoder_path)
        t.logger.save_dir = _relative_to(base, t.logger.save_dir)
        return config


def _load_raw(path: Path) -> dict:
    """The file's dict with its ``path_to_<key>_config_file`` partials
    merged under its inline sections."""
    data = _read_config_file(path)
    for key in _PARTIAL_KEYS:
        rel = data.get(f"path_to_{key}_config_file")
        if not rel:
            continue
        partial_path = Path(rel)
        if not partial_path.is_absolute():
            partial_path = (path.parent / partial_path).resolve()
        merged = _read_config_file(partial_path)
        if isinstance(data.get(key), dict):
            merged.update(data[key])
        data[key] = merged
    return data


# ---------------------------------------------------------------------------
# -c key.path=value overrides
# ---------------------------------------------------------------------------


def parse_override_value(value: str) -> Any:
    """`value` as ``yaml.safe_load`` reads it, or `value` itself where that
    raises (``config/__init__.py:630-634``): ``-c training.a=[1, 2`` keeps the
    string ``"[1, 2"``."""
    try:
        return safe_load(value)
    except YAMLError:
        return value


def apply_overrides(config_dict: dict, overrides: List[str]) -> dict:
    """Apply ``key.sub.path=value`` overrides onto a raw config dict
    (``config/__init__.py:638-651``)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must look like key.path=value, got: {item}")
        dotted, value = item.split("=", 1)
        keys = dotted.strip().split(".")
        node = config_dict
        for k in keys[:-1]:
            if k not in node or not isinstance(node[k], dict):
                node[k] = {}
            node = node[k]
        node[keys[-1]] = parse_override_value(value)
    return config_dict


def load_config_base_command(config_file: Union[str, Path],
                             config_args: Optional[List[str]] = None) -> FastSpeech2Config:
    """The config of a file with its partials merged and the ``-c``
    overrides applied before the paths resolve (``:654-663``)."""
    path = Path(config_file)
    raw = _load_raw(path)
    if config_args:
        raw = apply_overrides(raw, list(config_args))
    return FastSpeech2Config._from_raw(raw, path)
