"""Seeded inputs: texts, a preprocessed acoustic corpus and a vocoder corpus.

Every size (text lengths, frame counts, wav lengths, arrival gaps) is drawn
from a generator with a fixed seed, so every run offers the same work; the
run's seed draws the content (words, values) and the order. The text is
lower-case words and spaces, which every character inventory holds."""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence

import numpy as np

SIZE_SEED = 20240601  # the one seed of every size: the same work in every run
LETTERS = list("abcdefghijklmnopqrstuvwxyz")
WORDS = ("the a of and to in is was he for it with as his on be at by had are but from "
         "or have an they which one you were her all she there would their we him been "
         "has when who will more no if out so said what up its about into than them can "
         "only other new some could time these two may then do first any my now such like "
         "our over man me even most made after also did many before must through back "
         "years where much your way well down should because each just those people").split()
# the corpus statistics the variance adaptor's bins come from
STATS = {
    "pitch": dict(min=50.0, max=400.0, std=40.0, mean=150.0, norm_min=-2.5, norm_max=6.0),
    "energy": dict(min=0.0, max=90.0, std=12.0, mean=30.0, norm_min=-2.5, norm_max=5.0),
    "character_length": dict(min=10.0, max=160.0, std=30.0, mean=80.0, norm_min=10.0,
                             norm_max=160.0),
}
SPECIALS = ["\x80", " ", "<EXCL>", "<QINT>", "<QUOTE>", "<BB>", "<SB>", "<EPS>"]


def size_rng(tag: str) -> np.random.Generator:
    """The fixed generator of one kind of size."""
    return np.random.default_rng([SIZE_SEED, sum(map(ord, tag))])


def text_of_length(rng: np.random.Generator, n_chars: int) -> str:
    """Words drawn by `rng` until `n_chars` characters, cut there."""
    words: List[str] = []
    while len(" ".join(words)) < n_chars:
        words.append(str(rng.choice(WORDS)))
    text = " ".join(words)[:n_chars].strip()
    return text if len(text) == n_chars else text + "a" * (n_chars - len(text))


def encode(text: str) -> List[int]:
    """Character ids of an inventory of the specials then the letters."""
    return [1 if c == " " else len(SPECIALS) + LETTERS.index(c) for c in text]


def n_symbols() -> int:
    return len(SPECIALS) + len(LETTERS)


def bins(n_bins: int, kind: str) -> np.ndarray:
    st = STATS[kind]
    return np.linspace(st["norm_min"], st["norm_max"], n_bins - 1, dtype=np.float32)


def acoustic_sizes(n: int, chars: Sequence[int], frames_per_char: Sequence[float],
                   max_frames: int) -> List[tuple]:
    """n (characters, frames) pairs, the same in every run."""
    rng = size_rng("acoustic")
    out = []
    for _ in range(n):
        c = int(rng.integers(chars[0], chars[1] + 1))
        out.append((c, int(min(round(c * rng.uniform(*frames_per_char)), max_frames))))
    return out


def write_acoustic_corpus(root: Path, seed: int, sizes: List[tuple], n_mels: int,
                          spec_name: str) -> List[str]:
    """The preprocessed layout the trainer reads, one utterance a size in an
    order drawn from `seed`: a mel [n_mels, T] about -4, frame pitch (0 on
    unvoiced frames) and energy, a diagonal attention prior [T, L], the
    stats and a filelist. Returns the texts by utterance index."""
    rng = np.random.default_rng(seed % (1 << 63))
    order = rng.permutation(len(sizes))
    for kind in ("spec", "pitch", "energy", "attn"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    rows, texts = [], []
    for i, k in enumerate(order):
        n_chars, T = sizes[k]
        text = text_of_length(rng, n_chars)
        L = len(text)
        name = f"utt{i:04d}--default--default--"
        np.save(root / "spec" / (name + spec_name),
                (rng.standard_normal((n_mels, T), np.float32) - 4.0))
        voiced = rng.random(T) > 0.2
        np.save(root / "pitch" / (name + "pitch.npy"),
                (rng.standard_normal(T, np.float32) * voiced).astype(np.float32))
        np.save(root / "energy" / (name + "energy.npy"), rng.standard_normal(T, np.float32))
        centre = np.arange(T)[:, None] / max(T - 1, 1) * (L - 1)
        prior = np.exp(-((np.arange(L)[None, :] - centre) ** 2) / (2 * (L / 8 + 1) ** 2))
        np.save(root / "attn" / (name + "characters-attn-prior.npy"),
                (prior / prior.sum(1, keepdims=True)).astype(np.float32))
        rows.append(f"utt{i:04d}|default|default|{text}")
        texts.append(text)
    (root / "training_filelist.psv").write_text(
        "\n".join(["basename|speaker|language|characters"] + rows) + "\n")
    (root / "stats.json").write_text(json.dumps(STATS))
    return texts


def read_utterance(root: Path, basename: str, spec_name: str) -> dict:
    """One utterance's raw files as the corpus holds them."""
    name = f"{basename}--default--default--"
    return {"mel": np.load(root / "spec" / (name + spec_name)).T,
            "pitch": np.load(root / "pitch" / (name + "pitch.npy")),
            "energy": np.load(root / "energy" / (name + "energy.npy")),
            "attn_prior": np.load(root / "attn" / (name + "characters-attn-prior.npy"))}


def text_batches(seed: int, n_batches: int, batch: int, chars: Sequence[int]) -> List[List[str]]:
    """`n_batches` batches of `batch` texts: `n_batches` x `batch` lengths
    drawn uniform in `chars` by the fixed generator, the same set in every
    run, dealt into batches in an order drawn from `seed`, with words drawn
    from `seed`. Each batch has lengths of its own; the pool as a whole asks
    the same work of every seed."""
    lengths = size_rng("texts").integers(chars[0], chars[1] + 1, n_batches * batch)
    rng = np.random.default_rng(seed % (1 << 63))
    lengths = lengths[rng.permutation(len(lengths))].reshape(n_batches, batch)
    return [[text_of_length(rng, int(n)) for n in row] for row in lengths]
