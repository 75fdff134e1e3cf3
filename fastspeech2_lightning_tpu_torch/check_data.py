"""Dataset QA: the ``check-data`` command (counterpart of the JAX package's
``cli/check_data.py``).

Per utterance of a preprocessed corpus: speaking rates (words, characters
and phones a second), the clipped samples (the cheap count of samples at the
extremes, or with `clip_detection` the runs ``detect_clipping`` finds), the
pitch and energy statistics, the duration and the missing symbols, written
to ``checked-data.json``. With `objective_evaluation` the reference-free
``estimate_quality`` metrics join them (the JAX package's neural SQUIM
estimates need torchaudio and downloaded weights, and are not ported). With
`model_path` every utterance is scored by its teacher-forced losses through
``synthesize_items(return_scores=True)``, with its phone and trigram
coverage, into ``scores-{step}.psv``."""

from __future__ import annotations

import json
import sys
from collections import Counter
from pathlib import Path
from typing import List, Optional

import numpy as np

from .preprocessing.pipeline import Preprocessor, load_wav
from .utils import load_filelist

SQUIM_NOTE = ("torchaudio not installed: using native STOI/SI-SDR estimates (PESQ "
              "unavailable without SQUIM).")


def check_datapoint(item: dict, preprocessor: Preprocessor, word_seg_token: str = " ",
                    objective_evaluation: bool = False,
                    heavy_clip_detection: bool = False) -> dict:
    """The filelist row with its statistics added (``check_data.py:45-139``)."""
    data_point = dict(item)
    characters = item.get("characters") or item.get("text")
    phones = item.get("phones")
    if not (characters or phones):
        raise ValueError("Sorry, your data does not have characters or phones available in "
                         "the filelist, so we can't check the data.")
    character_tokens = item.get("character_tokens")
    phone_tokens = item.get("phone_tokens")
    if character_tokens is None and phone_tokens is None:
        ct, pt, _ = preprocessor.process_text(item)
        character_tokens = "/".join(ct) if ct else None
        phone_tokens = "/".join(pt) if pt else None
    default_text = phones if phones is not None else characters
    n_words = len(default_text.split(word_seg_token))
    n_chars = len(character_tokens.split("/")) if character_tokens else None
    n_phones = len(phone_tokens.split("/")) if phone_tokens else None

    a = preprocessor.audio_cfg
    speaker = item.get("speaker") or "default"
    language = item.get("language") or "default"

    def artifact(kind, fn):
        return preprocessor.artifact_path(kind, item["basename"], speaker, language, fn)

    audio = load_wav(artifact("audio", f"audio-{a.input_sampling_rate}.wav"),
                     a.input_sampling_rate)
    if objective_evaluation:
        from .preprocessing.objective import estimate_quality

        if not getattr(check_datapoint, "_warned_squim", False):
            check_datapoint._warned_squim = True
            print(SQUIM_NOTE, file=sys.stderr)
        data_point.update(estimate_quality(audio, a.input_sampling_rate))
    if heavy_clip_detection:
        from .preprocessing.objective import detect_clipping

        _, total_clipping = detect_clipping(audio)
    else:
        audio_max, audio_min = audio.max(), audio.min()
        total_clipping = int((audio >= audio_max).sum() + (audio <= audio_min).sum() - 2)

    pitch = np.load(artifact("pitch", "pitch.npy"))
    energy = np.load(artifact("energy", "energy.npy"))
    audio_length_s = len(audio) / a.input_sampling_rate
    data_point["total_clipped_samples"] = total_clipping
    for name, values in (("pitch", pitch), ("energy", energy)):
        data_point[f"{name}_min"] = float(values.min())
        data_point[f"{name}_max"] = float(values.max())
        data_point[f"{name}_mean"] = float(values.mean())
        data_point[f"{name}_std"] = float(values.std())
    data_point["duration"] = audio_length_s
    data_point["speaking_rate_words_per_second"] = n_words / audio_length_s
    if n_chars is not None:
        data_point["speaking_rate_characters_per_second"] = n_chars / audio_length_s
        data_point["n_chars"] = n_chars
    if n_phones is not None:
        data_point["speaking_rate_phones_per_second"] = n_phones / audio_length_s
        data_point["n_phones"] = n_phones
    data_point["n_missing_symbols"] = len(
        preprocessor.text_processor.get_missing_symbols(default_text))
    data_point["n_words"] = n_words
    return data_point


def check_data_from_filelist(preprocessor: Preprocessor, filelist: List[dict],
                             word_seg_token: str = " ", objective_evaluation: bool = False,
                             heavy_clip_detection: bool = False) -> List[dict]:
    return [check_datapoint(item, preprocessor, word_seg_token, objective_evaluation,
                            heavy_clip_detection) for item in filelist]


def add_coverage_scores(data: List[dict], preprocessor: Preprocessor) -> None:
    """Each row's phone and trigram coverage: the sums of 1/count of its
    tokens and of its (BOS/EOS padded) token trigrams over the filelist
    (``check_data.py:156-189``)."""

    def tokens_of(line: dict) -> List[str]:
        if line.get("character_tokens"):
            return line["character_tokens"].split("/")
        ct, pt, _ = preprocessor.process_text(line)
        return pt or ct

    def trigrams(tokens: List[str]):
        padded = ["<BOS>"] + list(tokens) + ["<EOS>"]
        return [tuple(padded[i: i + 3]) for i in range(len(padded) - 2)]

    token_counter: Counter = Counter()
    trigram_counter: Counter = Counter()
    token_cache = []
    for line in data:
        tokens = tokens_of(line)
        token_cache.append(tokens)
        token_counter.update(tokens)
        trigram_counter.update(trigrams(tokens))
    for line, tokens in zip(data, token_cache):
        line["phone_coverage_score"] = sum(1 / token_counter[t] for t in tokens)
        line["trigram_coverage_score"] = sum(1 / trigram_counter[n] for n in trigrams(tokens))


def check_data_command(config, filelist: Optional[Path], calculate_stats: bool,
                       model_path: Optional[Path], output_dir: Path,
                       objective_evaluation: bool = False, clip_detection: bool = False,
                       device=None) -> None:
    """``checked-data.json`` for the filelist (by default the training and
    validation filelists) and, with `model_path`, ``scores-{step}.psv`` from
    the model on `device` (the card unless "cpu" is asked for)
    (``check_data.py:192-242``)."""
    preprocessor = Preprocessor(config)
    output_dir = Path(output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)
    if filelist is None:
        combined = (load_filelist(config.training.training_filelist)
                    + load_filelist(config.training.validation_filelist))
    else:
        combined = load_filelist(filelist)

    if calculate_stats:
        stats = check_data_from_filelist(preprocessor, combined,
                                         objective_evaluation=objective_evaluation,
                                         heavy_clip_detection=clip_detection)
        if not stats:
            print("Sorry, the data is empty so there is nothing to check.")
            sys.exit(1)
        with open(output_dir / "checked-data.json", "w", encoding="utf8") as f:
            json.dump(stats, f)
        print(f"Wrote {output_dir / 'checked-data.json'}", flush=True)

    if model_path:
        from .checkpoint import load_model_from_checkpoint
        from .synthesis.synthesize import synthesize_items
        from .synthesis.writers import get_synthesis_output_writers

        model, mconfig, _, lang2id, speaker2id, global_step = load_model_from_checkpoint(
            Path(model_path), device=device)
        for item in combined:
            item.setdefault("is_last_input_chunk", True)
        add_coverage_scores(combined, preprocessor)
        writers = get_synthesis_output_writers(
            [], output_dir, mconfig,
            "postnet_output" if mconfig.model.use_postnet else "output",
            global_step, return_scores=True)
        synthesize_items(combined, model, mconfig, lang2id, speaker2id, writers, batch_size=1,
                         teacher_forcing=True, return_scores=True)
        print(f"Wrote {output_dir / f'scores-{global_step}.psv'}", flush=True)
