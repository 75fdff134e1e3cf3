"""The corpus preprocessor (counterpart of the JAX package's
``preprocessing/pipeline.py``).

Per utterance: the wav loaded, resampled and put through the source's sox
effects, filtered by length, then its artifacts written as ``.npy`` files
under ``save_dir/{audio,spec,attn,text,pfs,pitch,energy}`` named
``{basename}--{speaker}--{language}--{artifact}``: the PCM16 wav, the log-mel
(or linear or raw) spectrogram, the beta-binomial attention priors, the
token ids and phonological features, the YIN pitch (the NumPy golden; the
JAX package runs its C++ YIN where g++ builds it) and the frame energy. Then
the seeded train/validation split into two filelists, and ``stats.json``
with the pitch and energy artifacts z-normalized in place.

Utterances go through a pool of ``spawn``ed worker processes (a worker holds
no CUDA state, and the parent may), one pool for every source and one
``Preprocessor`` a worker; the spectrogram and the energy share one STFT. With
``on_device_spec`` the log-mel and the energy of the whole corpus are
computed afterwards on the card, in batches of 16 utterances padded to
multiples of 64 hops (``batched_mel_energy_torch``)."""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import multiprocessing as mp
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from ..config import CHARACTERS
from ..dataset import SEP
from ..text import TextProcessor
from ..text.features import get_features_for_tokens
from ..type_definitions import Stats
from ..utils import load_filelist, write_filelist
from .f0 import estimate_f0
from .features import energy_of, log_spectrogram, stft_complex_numpy, stft_magnitude_numpy
from .priors import beta_binomial_prior
from .stats import StatsAccumulator, save_stats

ALL_STEPS = ("audio", "spec", "attn", "text", "pitch", "energy")
DEVICE_BATCH = 16  # utterances a device-pass batch
BUCKET_HOPS = 64  # device-pass batches pad to multiples of this many hops


def load_wav(path: Path, target_sr: int) -> np.ndarray:
    """A wav file as float32 mono in [-1, 1], resampled to `target_sr`."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        audio = resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
    return audio


def _resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    from scipy.signal import resample_poly

    g = np.gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


def apply_sox_effects(audio: np.ndarray, sr: int, effects: list) -> tuple:
    """(audio, sample rate) after the sox effects the reference configs use
    (``pipeline.py:60-89``): ``channels 1`` (mono downmix), ``rate R``
    (resample), ``norm [dB]`` (peak to dB, -3 by default), ``gain dB`` and
    ``trim start [length]`` (seconds); other effects are ignored."""
    for effect in effects or []:
        name, *args = effect if isinstance(effect, (list, tuple)) else [effect]
        if name == "channels":
            if audio.ndim > 1 and int(args[0]) == 1:
                audio = audio.mean(axis=1)
        elif name == "rate":
            target = int(float(args[0]))
            if target != sr:
                audio = _resample(audio, sr, target)
                sr = target
        elif name == "norm":
            level_db = float(args[0]) if args else -3.0
            peak = np.abs(audio).max() or 1.0
            audio = audio * (10 ** (level_db / 20.0) / peak)
        elif name == "gain":
            audio = audio * (10 ** (float(args[0]) / 20.0))
        elif name == "trim":
            start = float(args[0]) if args else 0.0
            audio = audio[int(start * sr):]
            if len(args) > 1:
                audio = audio[: int(float(args[1]) * sr)]
    return audio.astype(np.float32), sr


def save_wav(path: Path, audio: np.ndarray, sr: int) -> None:
    """PCM16 mono wav: samples clipped to [-1, 1] and scaled by 32767."""
    from scipy.io import wavfile

    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))


def _save(path: Path, array: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, array)


class Preprocessor:
    """A corpus's artifacts, filelists and statistics from the config's
    ``preprocessing.source_data``."""

    def __init__(self, config):
        self.config = config
        self.audio_cfg = config.preprocessing.audio
        self.save_dir = Path(config.preprocessing.save_dir)
        self.text_processor = TextProcessor(config.text)
        self._g2p_cache: dict = {}

    def artifact_path(self, kind: str, basename: str, speaker: str, language: str,
                      fn: str) -> Path:
        """``<save_dir>/<kind>/<basename>--<speaker>--<language>--<fn>``
        (``pipeline.py:109-110``)."""
        return self.save_dir / kind / SEP.join([basename, speaker, language, fn])

    def spec_filename(self) -> str:
        a = self.audio_cfg
        return f"spec-{a.input_sampling_rate}-{a.spec_type}.npy"

    def process_text(self, item: dict, use_pfs: bool = False):
        """(character_tokens, phone_tokens, pfs) for a filelist item
        (``pipeline.py:118-151``). Phones come from a 'phones' column, else
        an 'arpabet' column (through the ARPABET to IPA table), else the
        language's g2p engine; `use_pfs` featurizes the phone tokens (the
        character tokens when there are none)."""
        text = item.get("characters") or item.get("text") or ""
        character_tokens = self.text_processor.process_text(text)
        phone_tokens = None
        phones = None
        if item.get("phones"):
            phone_tokens = self.text_processor.process_text(item["phones"])
        elif item.get("arpabet"):
            from ..text.g2p import arpabet_to_ipa

            phones = arpabet_to_ipa(item["arpabet"])
        else:
            engine = self._g2p_engine(item.get("language") or "default")
            if engine is not None:
                phones = engine(text)
        if phones is not None:
            if isinstance(phones, (list, tuple)):
                phone_tokens = [p for p in phones if p in self.text_processor.symbol_to_id]
            else:
                phone_tokens = self.text_processor.process_text(str(phones))
        pfs = get_features_for_tokens(phone_tokens or character_tokens) if use_pfs else None
        return character_tokens, phone_tokens, pfs

    def _g2p_engine(self, language: str):
        """The g2p callable of `language`, cached: the config's
        ``text.g2p_engines`` entry (a bundled engine's name or the dotted
        path of a callable) for the language or "default" wins; else, for a
        phone-level or phonological-feature model, the bundled engine of the
        language; else None (``pipeline.py:153-190``)."""
        if language in self._g2p_cache:
            return self._g2p_cache[language]
        from ..text.g2p import BUNDLED_ENGINES, get_g2p_engine

        engines = self.config.text.g2p_engines
        dotted = engines.get(language) or engines.get("default")
        engine = None
        if dotted and str(dotted) in BUNDLED_ENGINES:
            engine = BUNDLED_ENGINES[str(dotted)]
        elif dotted:
            module_name, _, attr = str(dotted).rpartition(".")
            try:
                engine = getattr(importlib.import_module(module_name), attr)
            except Exception as e:
                raise ValueError(
                    f"Could not load g2p engine '{dotted}' for language '{language}': {e}"
                ) from e
        elif self.config.model.target_text_representation_level != CHARACTERS:
            engine = get_g2p_engine(language)
        self._g2p_cache[language] = engine
        return engine

    def load_audio(self, data_dir: Path, basename: str, sox_effects: Optional[list]
                   ) -> np.ndarray:
        """The utterance's wav at the input rate, through the sox effects; a
        rate-changing effect is resampled back, so the spec, pitch and prior
        frame counts agree (``pipeline.py:208-219``)."""
        sr = self.audio_cfg.input_sampling_rate
        audio = load_wav(Path(data_dir) / f"{basename}.wav", sr)
        if sox_effects:
            audio, new_sr = apply_sox_effects(audio, sr, sox_effects)
            if new_sr != sr:
                audio = _resample(audio, new_sr, sr)
        return audio

    def process_utterance(self, item: dict, data_dir: Path, steps: Iterable[str] = ALL_STEPS,
                          sox_effects: Optional[list] = None,
                          defer_spectral: bool = False) -> Optional[dict]:
        """Write one utterance's artifacts of `steps`; returns its filelist
        row with the token strings, or None when its length is outside
        [min_audio_length, max_audio_length] (``pipeline.py:191-300``).
        `defer_spectral` leaves the spec and energy to the device pass."""
        a = self.audio_cfg
        basename = item["basename"]
        speaker = item.get("speaker") or "default"
        language = item.get("language") or "default"
        steps = set(steps)
        audio = self.load_audio(data_dir, basename, sox_effects)
        dur_s = len(audio) / a.input_sampling_rate
        if dur_s < a.min_audio_length or dur_s > a.max_audio_length:
            return None

        def path(kind, fn):
            return self.artifact_path(kind, basename, speaker, language, fn)

        if "audio" in steps:
            save_wav(path("audio", f"audio-{a.input_sampling_rate}.wav"), audio,
                     a.input_sampling_rate)
        n_frames = 1 + len(audio) // a.fft_hop_size
        spec = "spec" in steps and not defer_spectral
        energy = "energy" in steps and not defer_spectral
        # one STFT magnitude for the spectrogram and the energy
        mag = (stft_magnitude_numpy(audio, a.n_fft, a.fft_hop_size, a.fft_window_size)
               if energy or (spec and a.spec_type != "raw") else None)
        if spec:
            _save(path("spec", self.spec_filename()),
                  stft_complex_numpy(audio, a.n_fft, a.fft_hop_size, a.fft_window_size).T
                  if a.spec_type == "raw" else
                  log_spectrogram(mag, a.input_sampling_rate, a.n_fft, a.n_mels, a.f_min,
                                  a.f_max, a.spec_type))
        character_tokens, phone_tokens, pfs = self.process_text(item, use_pfs=True)
        if "text" in steps:
            _save(path("text", "text.npy"), np.asarray(
                self.text_processor.encode_tokens(character_tokens), dtype=np.int32))
            if pfs is not None:
                _save(path("pfs", "pfs.npy"), pfs)
        if "attn" in steps:
            for rep, tokens in (("characters", character_tokens), ("phones", phone_tokens)):
                if tokens:
                    _save(path("attn", f"{rep}-attn-prior.npy"),
                          beta_binomial_prior(n_frames, len(tokens)))
        if "pitch" in steps:
            _save(path("pitch", "pitch.npy"),
                  estimate_f0(audio, a.input_sampling_rate, a.fft_hop_size, n_frames))
        if energy:
            _save(path("energy", "energy.npy"), energy_of(mag))

        row = dict(item)
        row["basename"] = basename
        row["speaker"] = speaker
        row["language"] = language
        row["character_tokens"] = self.text_processor.encode_string_tokens(character_tokens)
        if phone_tokens:
            row["phone_tokens"] = self.text_processor.encode_string_tokens(phone_tokens)
        return row

    def run(self, steps: Iterable[str] = ALL_STEPS, cpus: Optional[int] = None,
            compute_stats: bool = True, on_device_spec: bool = False, device=None) -> dict:
        """Process every source filelist, write the split filelists and
        ``stats.json`` (``pipeline.py:303-368``); returns ``n_train``,
        ``n_val`` and, with `compute_stats`, ``stats``. `on_device_spec`
        computes the log-mel and energy on `device` (the card unless "cpu"
        is asked for) after the host pass; spec types other than the mels
        stay on the host path, with the JAX package's note."""
        steps = tuple(steps)
        if on_device_spec and self.audio_cfg.spec_type not in ("mel", "mel-librosa"):
            print(f"on-device spec supports mel spec types only "
                  f"(spec_type={self.audio_cfg.spec_type!r}) — using the host path")
            on_device_spec = False
        device_pass = on_device_spec and bool({"spec", "energy"} & set(steps))
        if device_pass:
            from ..device import resolve_device

            device = resolve_device(device)
        # every source's utterances through one pool, in filelist order
        tasks = [(item, Path(source.data_dir), list(source.sox_effects or []))
                 for source in self.config.preprocessing.source_data
                 for item in load_filelist(source.filelist)]
        n_workers = cpus or self.config.preprocessing.cpus or 1
        if n_workers > 1 and len(tasks) > 1:
            worker = functools.partial(_process_one, config=self.config, steps=steps,
                                       defer_spectral=on_device_spec)
            with mp.get_context("spawn").Pool(n_workers) as pool:
                rows = pool.map(worker, tasks, chunksize=1)
        else:
            rows = [self.process_utterance(item, data_dir, steps, effects, on_device_spec)
                    for item, data_dir, effects in tasks]
        all_rows = [r for r in rows if r is not None]
        device_queue = [(r, data_dir, effects)
                        for r, (_, data_dir, effects) in zip(rows, tasks) if r is not None]
        if device_pass:
            self._device_spectral_pass(device_queue, set(steps), device)

        rng = np.random.default_rng(self.config.preprocessing.dataset_split_seed)
        order = rng.permutation(len(all_rows))
        n_train = int(len(all_rows) * self.config.preprocessing.train_split)
        train_rows = [all_rows[i] for i in order[:n_train]]
        val_rows = [all_rows[i] for i in order[n_train:]]
        write_filelist(train_rows, self.save_dir / "training_filelist.psv")
        write_filelist(val_rows, self.save_dir / "validation_filelist.psv")
        result = {"n_train": len(train_rows), "n_val": len(val_rows)}
        if compute_stats:
            stats = self.compute_stats(all_rows, normalize=True)
            save_stats(stats, self.save_dir / "stats.json")
            result["stats"] = stats
        return result

    def device_batches(self, queue: List[tuple]):
        """(rows, [B, padded] float32 batch) for the device pass
        (``pipeline.py:401-435``): utterances bucketed by their length plus
        the tail pad, rounded up to a multiple of 64 hops, in batches of 16;
        each row is followed by its mirror image, as the host path's reflect
        padding has it, as far as the row allows."""
        a = self.audio_cfg
        bucket_samples = a.fft_hop_size * BUCKET_HOPS
        pad = a.n_fft // 2
        buckets: dict = {}
        for row, data_dir, effects in queue:
            audio = self.load_audio(data_dir, row["basename"], effects)
            padded_len = -(-(len(audio) + pad) // bucket_samples) * bucket_samples
            buckets.setdefault(padded_len, []).append((row, audio))
        for padded_len, entries in buckets.items():
            for start in range(0, len(entries), DEVICE_BATCH):
                chunk = entries[start: start + DEVICE_BATCH]
                batch = np.zeros((len(chunk), padded_len), dtype=np.float32)
                for i, (_, audio) in enumerate(chunk):
                    n = len(audio)
                    batch[i, :n] = audio
                    ext = min(padded_len - n, n - 1)
                    if ext > 0:
                        batch[i, n: n + ext] = audio[-2: -ext - 2: -1]
                yield chunk, batch

    def _device_spectral_pass(self, queue: List[tuple], steps: set, device) -> None:
        """The log-mel and energy of every queued utterance, computed on
        `device` batch by batch and cropped to its frames
        (``pipeline.py:370-447``)."""
        import torch

        from .features import batched_mel_energy_torch

        a = self.audio_cfg
        for chunk, batch in self.device_batches(queue):
            mel, energy = batched_mel_energy_torch(
                torch.from_numpy(batch).to(device), a.input_sampling_rate, a.n_fft,
                a.fft_hop_size, a.fft_window_size, a.n_mels, a.f_min, a.f_max,
                htk=a.spec_type == "mel")
            mel, energy = mel.cpu().numpy(), energy.cpu().numpy()
            for i, (row, audio) in enumerate(chunk):
                n_frames = 1 + len(audio) // a.fft_hop_size
                b, s, l = row["basename"], row["speaker"], row["language"]
                if "spec" in steps:
                    _save(self.artifact_path("spec", b, s, l, self.spec_filename()),
                          mel[i, :, :n_frames])
                if "energy" in steps:
                    _save(self.artifact_path("energy", b, s, l, "energy.npy"),
                          energy[i, :n_frames])

    def compute_stats(self, rows: List[dict], normalize: bool = True) -> Stats:
        """The pitch and energy scalers and the text-length statistics; with
        `normalize` the saved pitch and energy are z-normalized in place
        (``pipeline.py:449-484``)."""
        p_acc, e_acc = StatsAccumulator(), StatsAccumulator()
        c_acc, ph_acc = StatsAccumulator(), StatsAccumulator()
        paths = []
        for row in rows:
            b, s, l = row["basename"], row["speaker"], row["language"]
            pp = self.artifact_path("pitch", b, s, l, "pitch.npy")
            ep = self.artifact_path("energy", b, s, l, "energy.npy")
            if pp.exists():
                p_acc.update(np.load(pp))
            if ep.exists():
                e_acc.update(np.load(ep))
            paths.append((pp, ep))
            if row.get("character_tokens"):
                c_acc.update(np.array([len(row["character_tokens"].split("/"))]))
            if row.get("phone_tokens"):
                ph_acc.update(np.array([len(row["phone_tokens"].split("/"))]))
        if normalize:
            for pp, ep in paths:
                if pp.exists():
                    np.save(pp, p_acc.normalize(np.load(pp)))
                if ep.exists():
                    np.save(ep, e_acc.normalize(np.load(ep)))
        return Stats(pitch=p_acc.finalize(), energy=e_acc.finalize(),
                     character_length=c_acc.finalize() if c_acc.n else None,
                     phone_length=ph_acc.finalize() if ph_acc.n else None)


_WORKER_PRE: dict = {}  # a worker process's Preprocessor, keyed on its config


def _worker_preprocessor(config) -> Preprocessor:
    """One Preprocessor a worker process (its TextProcessor and g2p engines
    cost as much as a short clip's features); the pool pickles the config
    with every task, so its JSON dump keys the memo."""
    key = json.dumps(dataclasses.asdict(config), sort_keys=True, default=str)
    pre = _WORKER_PRE.get(key)
    if pre is None:
        _WORKER_PRE.clear()
        pre = _WORKER_PRE[key] = Preprocessor(config)
    return pre


def _process_one(task: tuple, config, steps, defer_spectral: bool = False):
    """The pool's task, (item, data_dir, sox_effects): one utterance through
    its worker's Preprocessor."""
    item, data_dir, sox_effects = task
    return _worker_preprocessor(config).process_utterance(item, data_dir, steps, sox_effects,
                                                          defer_spectral)
