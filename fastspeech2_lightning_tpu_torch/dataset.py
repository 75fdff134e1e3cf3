"""Training data: per-utterance artifacts, collation to static shapes, and
the bucketed loader (counterpart of the JAX package's ``dataset.py``).

Artifacts are named ``{basename}--{speaker}--{language}--{artifact}`` under
``preprocessing.save_dir``. Utterances are grouped into a few (text, mel)
length buckets from corpus quantiles; a bucket pads its text to a multiple of
16 and its mel to a multiple of 32 (capped at ``model.max_mel_length``), and
the last partial batch of a bucket is filled with bucket-mates of
``sample_weight`` 0. The padding decides the losses' denominators
(``training/loss.py``), so buckets and padding equal the JAX package's for
the same corpus and seed. Batches are numpy dicts; the trainer moves them to
the device. Phone-level and phonological-feature models read the
``phone_tokens`` column (or run g2p on an item without it) and the
phonological features from ``pfs.npy``, as the JAX package's ``preprocess``
writes them."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .config import CHARACTERS, PHONOLOGICAL_FEATURES, FastSpeech2Config
from .text import TextProcessor
from .text.lookups import LookupTable, load_filelist

PAD_MULT_TEXT = 16
PAD_MULT_MEL = 32
SEP = "--"
COVERAGE_KEYS = ("phone_coverage_score", "trigram_coverage_score")


def _round_up(n: int, mult: int) -> int:
    return max(mult, int(math.ceil(n / mult)) * mult)


def token_key(config: FastSpeech2Config) -> str:
    """The filelist column that holds a model's tokens."""
    level = config.model.target_text_representation_level
    return "character_tokens" if level == CHARACTERS else "phone_tokens"


class FastSpeechDataset:
    """Loads one utterance's artifacts (``dataset.py:44-190``): text ids
    capped at ``model.max_length``, the mel [T, n_mels], the attention prior
    (or the durations without learned alignment), pitch and energy, and for
    a phonological-feature model its features [L, N_PHONOLOGICAL_FEATURES].
    At `inference` only the text is loaded, and with `teacher_forcing` also
    the mel and the prior (or durations); with `style_reference` an item's
    ``mel_style_reference`` rides along. Every item carries its raw text,
    ``duration_control`` and ``is_last_input_chunk`` for the synthesis
    writers."""

    def __init__(self, items: List[dict], config: FastSpeech2Config,
                 lang2id: LookupTable, speaker2id: LookupTable,
                 teacher_forcing: bool = False, inference: bool = False,
                 style_reference: bool = False):
        self.items = items
        self.config = config
        self.preprocessed_dir = Path(config.preprocessing.save_dir)
        self.text_processor = TextProcessor(config.text)
        self.lang2id = lang2id
        self.speaker2id = speaker2id
        self.teacher_forcing = teacher_forcing
        self.inference = inference
        self.style_reference = style_reference
        self._preprocessor = None

    def __len__(self):
        return len(self.items)

    def path(self, item: dict, kind: str, name: str) -> Path:
        return self.preprocessed_dir / kind / SEP.join(
            [item["basename"], item.get("speaker") or "default",
             item.get("language") or "default", name])

    def spec_name(self) -> str:
        a = self.config.preprocessing.audio
        return f"spec-{a.input_sampling_rate}-{a.spec_type}.npy"

    def encode_text(self, item: dict) -> np.ndarray:
        """The item's symbol ids (``dataset.py:78-98``): its token column
        when it has one; else, for a phone-level model, the phones
        ``Preprocessor.process_text`` gives (g2p for an ad-hoc item); else
        its characters."""
        key = token_key(self.config)
        if item.get(key):
            ids = self.text_processor.encode_escaped_string_sequence(item[key])
        elif key == "phone_tokens":
            if self._preprocessor is None:
                from .preprocessing.pipeline import Preprocessor

                self._preprocessor = Preprocessor(self.config)
            _, phone_tokens, _ = self._preprocessor.process_text(item)
            ids = self.text_processor.encode_tokens(phone_tokens or [])
        else:
            ids = self.text_processor.encode_text(item.get("characters") or item.get("text") or "")
        return np.asarray(ids, dtype=np.int32)

    def __getitem__(self, index: int) -> dict:
        item = self.items[index]
        speaker = item.get("speaker") or "default"
        language = item.get("language") or "default"
        text = self.encode_text(item)[: self.config.model.max_length]
        loaded = {
            "basename": item["basename"],
            "speaker": speaker,
            "speaker_id": self.speaker2id.get(speaker, 0),
            "language": language,
            "language_id": self.lang2id.get(language, 0),
            "raw_text": item.get("characters") or item.get("text") or "",
            "duration_control": float(item.get("duration_control") or 1.0),
            "is_last_input_chunk": bool(item.get("is_last_input_chunk", True)),
            "text": text,
        }
        if not self.inference or self.teacher_forcing:
            self._load_targets(item, loaded)
        if not self.inference:
            loaded["energy"] = np.load(self.path(item, "energy", "energy.npy")).astype(np.float32)
            loaded["pitch"] = np.load(self.path(item, "pitch", "pitch.npy")).astype(np.float32)
            if self.config.model.target_text_representation_level == PHONOLOGICAL_FEATURES:
                loaded["pfs"] = np.load(self.path(item, "pfs", "pfs.npy")).astype(np.float32)
        if self.style_reference and "mel_style_reference" in item:
            loaded["mel_style_reference"] = item["mel_style_reference"]
        for key in COVERAGE_KEYS:  # check-data's scores ride along
            if key in item:
                loaded[key] = float(item[key])
        return loaded

    def _load_targets(self, item: dict, loaded: dict) -> None:
        """The mel and the attention prior (or the durations)."""
        loaded["mel"] = np.load(self.path(item, "spec", self.spec_name())).T.astype(np.float32)
        if self.config.model.learn_alignment:
            rep = "characters" if token_key(self.config) == "character_tokens" else "phones"
            loaded["attn_prior"] = np.load(
                self.path(item, "attn", f"{rep}-attn-prior.npy")).astype(np.float32)
        else:
            duration = np.load(self.path(item, "duration", "duration.npy")).astype(np.int32)
            if int(duration.sum()) != loaded["mel"].shape[0]:
                raise ValueError(
                    f"{item['basename']}: durations sum to {int(duration.sum())} but the "
                    f"mel has {loaded['mel'].shape[0]} frames"
                )
            loaded["duration"] = duration


def collate(samples: List[dict], pad_text_to: int, pad_mel_to: Optional[int],
            learn_alignment: bool = True,
            variance_levels: Optional[Dict[str, str]] = None) -> dict:
    """Pad per-utterance dicts into one fixed-shape numpy batch
    (``dataset.py:202-317``): lengths clipped to the padded axes, pitch and
    energy at frame level with learned alignment, else at the level the
    config names. `pad_mel_to` None pads the mels to the longest; without
    mels (inference) it is only recorded as ``max_mel_len`` and
    ``mel_lens`` is None. The host keys (speaker and language names, raw
    text, chunk flags) and ``duration_control`` ride along for the
    synthesis writers; phonological features pad to [B, L, features] and
    style references to the longest one."""
    B = len(samples)
    L = pad_text_to
    src_lens = np.minimum(np.array([s["text"].shape[0] for s in samples], np.int32), L)
    has_mel = samples[0].get("mel") is not None
    mel_lens = None
    T = pad_mel_to
    if has_mel:
        mel_lens = np.array([s["mel"].shape[0] for s in samples], np.int32)
        T = T or int(mel_lens.max())
        mel_lens = np.minimum(mel_lens, T)
    batch: Dict[str, object] = {
        "src_lens": src_lens,
        "mel_lens": mel_lens,
        "max_src_len": L,
        "max_mel_len": T,
        "basename": [s["basename"] for s in samples],
        "speaker": [s.get("speaker") for s in samples],
        "language": [s.get("language") for s in samples],
        "raw_text": [s.get("raw_text", "") for s in samples],
        "speaker_id": np.array([s["speaker_id"] for s in samples], np.int32),
        "language_id": np.array([s["language_id"] for s in samples], np.int32),
        "duration_control": np.array([s.get("duration_control", 1.0) for s in samples],
                                     np.float32),
        "is_last_input_chunk": [s.get("is_last_input_chunk", True) for s in samples],
    }
    for key in COVERAGE_KEYS:
        if key in samples[0]:
            batch[key] = np.array([s[key] for s in samples], np.float32)
    text = np.zeros((B, L), np.int32)
    for i, s in enumerate(samples):
        text[i, : src_lens[i]] = s["text"][:L]
    batch["text"] = text
    if has_mel:
        mel = np.zeros((B, T, samples[0]["mel"].shape[1]), np.float32)
        for i, s in enumerate(samples):
            mel[i, : mel_lens[i]] = s["mel"][:T]
        batch["mel"] = mel
    for key in ("pitch", "energy"):
        if key not in samples[0]:
            continue
        frame = learn_alignment or (variance_levels or {}).get(key) == "frame"
        W = T if frame else L
        arr = np.zeros((B, W), np.float32)
        for i, s in enumerate(samples):
            n = min(s[key].shape[0], W)
            arr[i, :n] = s[key][:n]
        batch[key] = arr
    if "attn_prior" in samples[0]:
        prior = np.zeros((B, T, L), np.float32)
        for i, s in enumerate(samples):
            p = s["attn_prior"]
            prior[i, : min(p.shape[0], T), : min(p.shape[1], L)] = p[:T, :L]
        batch["attn_prior"] = prior
    if "duration" in samples[0]:
        dur = np.zeros((B, L), np.int32)
        for i, s in enumerate(samples):
            d = s["duration"]
            dur[i, : min(d.shape[0], L)] = d[:L]
        batch["duration"] = dur
    if samples[0].get("pfs") is not None:
        pfs = np.zeros((B, L, samples[0]["pfs"].shape[1]), np.float32)
        for i, s in enumerate(samples):
            pfs[i, : min(s["pfs"].shape[0], L)] = s["pfs"][:L]
        batch["pfs"] = pfs
    if samples[0].get("mel_style_reference") is not None:
        refs = [np.asarray(s["mel_style_reference"]) for s in samples]
        ref = np.zeros((B, max(r.shape[0] for r in refs), refs[0].shape[1]), np.float32)
        for i, r in enumerate(refs):
            ref[i, : r.shape[0]] = r
        batch["mel_style_reference"] = ref
    return batch


@dataclass
class Bucket:
    max_text: int
    max_mel: int
    indices: List[int] = field(default_factory=list)


class BucketedLoader:
    """Static (text, mel) length buckets and shuffled fixed-shape batches
    (``dataset.py:332-581``): each epoch shuffles within the buckets, cuts
    batches, fills a bucket's last partial batch with random bucket-mates of
    sample_weight 0, and shuffles the batch order, all from one numpy
    generator seeded with `seed`.

    `batch_size` is the global batch size. `shard=(i, n)` yields only data
    rank i's contiguous rows of each global batch: every rank draws the same
    plan from the same seed (the same batches, buckets and padding) and
    collates its own rows. Each batch carries ``n_real_global``, the global
    batch's real rows, which weights a validation batch alike on every
    rank."""

    def __init__(self, dataset: FastSpeechDataset, batch_size: int, n_buckets: int = 4,
                 seed: int = 0, use_weighted_sampler: bool = False,
                 max_mel_length: Optional[int] = None, shard: Tuple[int, int] = (0, 1)):
        if shard[1] > 1 and batch_size % shard[1] != 0:
            raise ValueError(f"global batch_size={batch_size} must divide evenly over "
                             f"{shard[1]} data ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.rng = np.random.default_rng(seed)
        self.use_weighted_sampler = use_weighted_sampler
        text_lens, mel_lens = [], []
        spec = dataset.spec_name()
        key = token_key(dataset.config)
        for item in dataset.items:
            tokens = item.get(key)
            text_lens.append(len(tokens.split("/")) if tokens else len(dataset.encode_text(item)))
            p = dataset.path(item, "spec", spec)
            mel_lens.append(np.load(p, mmap_mode="r").shape[1] if p.exists() else 0)
        self.text_lens = np.array(text_lens)
        self.mel_lens = np.array(mel_lens)

        edges = np.unique(np.quantile(self.mel_lens, np.linspace(0, 1, n_buckets + 1)[1:])
                          .astype(int))
        self.buckets: List[Bucket] = []
        lo = -1
        for edge in edges:
            sel = np.where((self.mel_lens > lo) & (self.mel_lens <= edge))[0]
            if len(sel) == 0:
                continue
            mt = _round_up(int(self.text_lens[sel].max()), PAD_MULT_TEXT)
            mm = _round_up(int(self.mel_lens[sel].max()), PAD_MULT_MEL)
            if max_mel_length:
                mm = min(mm, max_mel_length)
            self.buckets.append(Bucket(mt, mm, list(sel)))
            lo = edge

    def __len__(self):
        return sum(math.ceil(len(b.indices) / self.batch_size) for b in self.buckets)

    def _weights(self, indices) -> np.ndarray:
        """Inverse corpus-wide (language, speaker) frequencies, normalized
        within the bucket."""
        from collections import Counter

        items = self.dataset.items

        def key(item):
            return (item.get("language") or "default", item.get("speaker") or "default")

        counts = Counter(key(item) for item in items)
        w = np.array([1.0 / counts[key(items[i])] for i in indices])
        return w / w.sum()

    def __iter__(self) -> Iterator[dict]:
        orders = []
        for b in self.buckets:
            idx = np.array(b.indices)
            if self.use_weighted_sampler and len(idx) > 0:
                idx = self.rng.choice(idx, size=len(idx), replace=True, p=self._weights(b.indices))
            else:
                idx = self.rng.permutation(idx)
            orders.append(idx)
        batches = []
        for b, idx in zip(self.buckets, orders):
            for start in range(0, len(idx), self.batch_size):
                chunk = idx[start: start + self.batch_size]
                n_real = len(chunk)
                if n_real == 0:
                    continue
                if n_real < self.batch_size:
                    chunk = np.concatenate([chunk, self.rng.choice(idx, self.batch_size - n_real)])
                batches.append((b, chunk, n_real))
        self.rng.shuffle(batches)

        cfg = self.dataset.config
        vp = cfg.model.variance_predictors
        levels = {"pitch": vp.pitch.level, "energy": vp.energy.level}
        rank, n_ranks = self.shard
        per = self.batch_size // n_ranks
        for b, chunk, n_real in batches:
            weights = np.ones(len(chunk), np.float32)
            weights[n_real:] = 0.0
            if n_ranks > 1:
                chunk = chunk[rank * per:(rank + 1) * per]
                weights = weights[rank * per:(rank + 1) * per]
            batch = collate([self.dataset[int(i)] for i in chunk], b.max_text, b.max_mel,
                            learn_alignment=cfg.model.learn_alignment,
                            variance_levels=levels)
            batch["sample_weight"] = weights
            batch["n_real_global"] = n_real
            yield batch


def load_datasets(config: FastSpeech2Config, lang2id: LookupTable, speaker2id: LookupTable):
    """(train, validation) datasets from the config's filelists."""
    return tuple(
        FastSpeechDataset(load_filelist(path), config, lang2id, speaker2id)
        for path in (config.training.training_filelist, config.training.validation_filelist)
    )
