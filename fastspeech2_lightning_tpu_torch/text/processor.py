"""Text processing: cleaners, symbol inventory, tokenization, encode/decode.

A copy of the JAX package's ``text/processor.py``, which re-provides the
everyvoice TextProcessor surface the reference depends on (encode_text,
encode_escaped_string_sequence, decode_tokens, get_missing_symbols, symbol
inventory with internal pad "\\x80", punctuation internal tokens
<EXCL>/<QINT>/<QUOTE>/<BB>/<SB>/<EPS>).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable, List, Optional

from ..config import TextConfig

# Internal pad symbol — always id 0 (fs2/model.py:86-88 uses
# text_processor._pad_symbol = "\x80" as the Embedding padding_idx).
PAD_SYMBOL = "\x80"

# Punctuation gets mapped to internal placeholder tokens so that models can
# learn pause/prosody classes rather than individual marks.
PUNCTUATION_INTERNAL = {
    "exclamations": "<EXCL>",
    "question_symbols": "<QINT>",
    "quotemarks": "<QUOTE>",
    "big_breaks": "<BB>",
    "small_breaks": "<SB>",
    "ellipsis": "<EPS>",
}

PUNCTUATION_CLASSES = {
    "exclamations": ["!", "¡"],
    "question_symbols": ["?", "¿"],
    "quotemarks": ['"', "'", "“", "”", "‘", "’", "«", "»"],
    "big_breaks": [".", ":", ";"],
    "small_breaks": [",", "-", "—", "–"],
    "ellipsis": ["…"],
}

# Symbols always present, in fixed order, ahead of dataset symbols
# (matches the reference's hardcoded-initial list, fs2/model.py:314-323).
HARDCODED_INITIAL_SYMBOLS = [
    PAD_SYMBOL,
    " ",
    "<EXCL>",
    "<QINT>",
    "<QUOTE>",
    "<BB>",
    "<SB>",
    "<EPS>",
]


# ---------------------------------------------------------------------------
# Cleaners
# ---------------------------------------------------------------------------


def lower(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def nfc_normalize(text: str) -> str:
    return unicodedata.normalize("NFC", text)


def nfkc_normalize(text: str) -> str:
    return unicodedata.normalize("NFKC", text)


CLEANERS = {
    "lower": lower,
    "collapse_whitespace": collapse_whitespace,
    "nfc_normalize": nfc_normalize,
    "nfkc_normalize": nfkc_normalize,
}


def symbol_sorter(
    symbols: Iterable[str], hardcoded_initial_symbols: Optional[List[str]] = None
) -> List[str]:
    """Deterministic symbol ordering: hardcoded initials first, then dataset
    symbols sorted by (length descending, codepoint) so that greedy
    tokenization prefers the longest match."""
    if hardcoded_initial_symbols is None:
        hardcoded_initial_symbols = list(HARDCODED_INITIAL_SYMBOLS)
    rest = sorted(
        {s for s in symbols if s not in hardcoded_initial_symbols},
        key=lambda s: (-len(s), s),
    )
    return list(hardcoded_initial_symbols) + rest


def get_symbols_from_symbol_dict(symbol_dict: dict) -> List[str]:
    """Flatten a TextConfig.symbols mapping into the dataset symbol list,
    skipping the 'pad' display entry (the internal pad is PAD_SYMBOL)."""
    out: List[str] = []
    for key, val in symbol_dict.items():
        if key == "pad":
            continue
        if isinstance(val, str):
            out.append(val)
        else:
            out.extend(val)
    return out


class TextProcessor:
    """Tokenizes cleaned text into the model's symbol inventory."""

    def __init__(self, config: TextConfig):
        self.config = config
        self._pad_symbol = PAD_SYMBOL
        self.cleaner_fns = [CLEANERS[c] for c in config.cleaners if c in CLEANERS]
        dataset_symbols = get_symbols_from_symbol_dict(config.symbols)
        self.symbols: List[str] = symbol_sorter(dataset_symbols)
        self.symbol_to_id = {s: i for i, s in enumerate(self.symbols)}
        self.id_to_symbol = {i: s for i, s in enumerate(self.symbols)}
        self.silence_symbols = list(config.symbols.get("silence", []))
        self.to_replace = dict(config.to_replace)
        # punctuation char -> internal token
        self.punct_map = {}
        for cls_name, marks in PUNCTUATION_CLASSES.items():
            for m in marks:
                self.punct_map[m] = PUNCTUATION_INTERNAL[cls_name]
        # precompute multi-char symbols for greedy matching (longest first)
        self._multichar = sorted(
            (s for s in self.symbols if len(s) > 1 and not s.startswith("<")),
            key=len,
            reverse=True,
        )

    # -- cleaning ----------------------------------------------------------

    def apply_cleaners(self, text: str) -> str:
        for pattern, repl in self.to_replace.items():
            text = re.sub(pattern, repl, text)
        for fn in self.cleaner_fns:
            text = fn(text)
        return text

    def normalize_punctuation(self, tokens: List[str]) -> List[str]:
        return [self.punct_map.get(t, t) for t in tokens]

    # -- tokenization ------------------------------------------------------

    def tokenize_characters(self, text: str) -> List[str]:
        """Greedy longest-match tokenization over the symbol inventory."""
        tokens: List[str] = []
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for sym in self._multichar:
                if text.startswith(sym, i):
                    tokens.append(sym)
                    i += len(sym)
                    matched = True
                    break
            if not matched:
                tokens.append(text[i])
                i += 1
        return self.normalize_punctuation(tokens)

    def process_text(self, text: str) -> List[str]:
        """Clean + tokenize, keeping only known symbols."""
        cleaned = self.apply_cleaners(text)
        tokens = self.tokenize_characters(cleaned)
        return [t for t in tokens if t in self.symbol_to_id]

    def get_missing_symbols(self, text: str) -> List[str]:
        cleaned = self.apply_cleaners(text)
        tokens = self.tokenize_characters(cleaned)
        return [t for t in tokens if t not in self.symbol_to_id]

    # -- encoding ----------------------------------------------------------

    def encode_text(self, text: str) -> List[int]:
        return [self.symbol_to_id[t] for t in self.process_text(text)]

    def encode_tokens(self, tokens: List[str]) -> List[int]:
        return [self.symbol_to_id[t] for t in tokens if t in self.symbol_to_id]

    def encode_escaped_string_sequence(
        self, string_of_tokens: str, split_character: str = "/"
    ) -> List[int]:
        """Encode a '/'-joined token string (the on-disk filelist format for
        pre-tokenized text, fs2/dataset.py:157-170)."""
        return self.encode_tokens(string_of_tokens.split(split_character))

    def encode_string_tokens(self, tokens: List[str]) -> str:
        return "/".join(tokens)

    def decode_tokens(self, ids: Iterable[int], join_character: str = "") -> str:
        return join_character.join(
            self.id_to_symbol[int(i)] for i in ids if int(i) in self.id_to_symbol
        )

    def token_sequence_to_text_sequence(self, ids: Iterable[int]) -> List[str]:
        return [self.id_to_symbol[int(i)] for i in ids if int(i) in self.id_to_symbol]
