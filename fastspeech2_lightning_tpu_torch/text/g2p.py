"""Bundled grapheme→phoneme engines (a copy of the JAX package's
``text/g2p.py``; the same phones for the same text).

The reference gets g2p from everyvoice's `g2p` library (consumed at
fs2/dataset.py:155-174 via Preprocessor.process_text); the repository is
self-contained, so a minimal engine ships in-tree to make the
`ipa_phones` / `phonological_features` representation levels usable with no
user-supplied callable:

* ``english_g2p`` — deterministic rule-based English grapheme→IPA
  (digraph/trigraph rules + letter defaults; approximate by design, good
  enough to train/synthesize on the phones path end to end).
* ``characters_g2p`` — identity passthrough for near-phonemic orthographies
  (each NFC character is a phone); the fallback for languages without a
  bundled rule set — many of the low-resource orthographies the reference
  targets are engineered to be phonemic, where this is the right default.
* ``arpabet_to_ipa`` — standard CMUdict ARPABET→IPA table, used for filelists
  carrying an `arpabet` column (DatasetTextRepresentation.arpabet).

Custom engines still take precedence: `text.g2p_engines` maps a language to a
dotted path of a callable ``str -> str | list[str]`` (or to a bundled engine
name ``"english"`` / ``"characters"``).
"""

from __future__ import annotations

import logging
import unicodedata
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# ARPABET -> IPA (CMUdict symbol set; stress digits stripped)
# ---------------------------------------------------------------------------

ARPABET_TO_IPA = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ", "ER": "ɝ",
    "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ", "IY": "i",
    "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpabet_to_ipa(arpabet: str | List[str]) -> List[str]:
    """ARPABET tokens (string or list; stress digits allowed) → IPA phones.

    Unknown tokens pass through unchanged (they will be dropped later if not
    in the symbol inventory); spaces separate words and are kept."""
    if isinstance(arpabet, str):
        tokens = arpabet.replace("/", " ").split(" ")
    else:
        tokens = list(arpabet)
    out: List[str] = []
    for tok in tokens:
        if tok == "":
            if out and out[-1] != " ":
                out.append(" ")
            continue
        key = tok.rstrip("012").upper()
        if key == "AH" and tok.endswith("0"):
            out.append("ə")  # CMUdict AH0 is the reduced vowel (schwa)
        else:
            out.append(ARPABET_TO_IPA.get(key, tok))
    # single space between words, none at the edges
    while out and out[-1] == " ":
        out.pop()
    while out and out[0] == " ":
        out.pop(0)
    return out


# ---------------------------------------------------------------------------
# Rule-based English grapheme -> IPA
# ---------------------------------------------------------------------------

# Ordered longest-match spelling rules. A rule maps a grapheme cluster to a
# sequence of IPA phones. This is intentionally simple and deterministic —
# approximate pronunciations are fine for TTS token streams (the model learns
# acoustics per token), what matters is a consistent, reasonably phonemic
# mapping.
_ENG_RULES: List[tuple[str, List[str]]] = [
    ("tch", ["tʃ"]),
    ("igh", ["aɪ"]),
    ("eigh", ["eɪ"]),
    ("ough", ["oʊ"]),
    ("augh", ["ɔ"]),
    ("tion", ["ʃ", "ʌ", "n"]),
    ("sion", ["ʒ", "ʌ", "n"]),
    ("ing", ["ɪ", "ŋ"]),
    ("ch", ["tʃ"]),
    ("sh", ["ʃ"]),
    ("th", ["θ"]),
    ("ph", ["f"]),
    ("wh", ["w"]),
    ("ng", ["ŋ"]),
    ("qu", ["k", "w"]),
    ("ck", ["k"]),
    ("kn", ["n"]),
    ("wr", ["ɹ"]),
    ("ee", ["i"]),
    ("ea", ["i"]),
    ("oo", ["u"]),
    ("ou", ["aʊ"]),
    ("ow", ["aʊ"]),
    ("oy", ["ɔɪ"]),
    ("oi", ["ɔɪ"]),
    ("ai", ["eɪ"]),
    ("ay", ["eɪ"]),
    ("oa", ["oʊ"]),
    ("ie", ["i"]),
    ("er", ["ɝ"]),
    ("ar", ["ɑ", "ɹ"]),
    ("or", ["ɔ", "ɹ"]),
    ("x", ["k", "s"]),
    ("a", ["æ"]),
    ("b", ["b"]),
    ("c", ["k"]),
    ("d", ["d"]),
    ("e", ["ɛ"]),
    ("f", ["f"]),
    ("g", ["ɡ"]),
    ("h", ["h"]),
    ("i", ["ɪ"]),
    ("j", ["dʒ"]),
    ("k", ["k"]),
    ("l", ["l"]),
    ("m", ["m"]),
    ("n", ["n"]),
    ("o", ["ɑ"]),
    ("p", ["p"]),
    ("q", ["k"]),
    ("r", ["ɹ"]),
    ("s", ["s"]),
    ("t", ["t"]),
    ("u", ["ʌ"]),
    ("v", ["v"]),
    ("w", ["w"]),
    ("y", ["j"]),
    ("z", ["z"]),
]


# magic-e long vowel forms ("shape" -> ʃ eɪ p)
_LONG_VOWEL = {"a": "eɪ", "e": "i", "i": "aɪ", "o": "oʊ", "u": "u"}


def _eng_word(word: str) -> List[str]:
    # curated high-frequency lexicon first (irregular spellings, vowel
    # reduction, stress); spelling rules are the OOV fallback
    from .lexicon import lookup

    entry = lookup(word)
    if entry is not None:
        return entry
    # magic-e: a word-final silent 'e' after a consonant is dropped and the
    # preceding single vowel takes its long form
    long_idx = -1
    if (
        len(word) >= 3
        and word.endswith("e")
        and word[-2] not in "aeiou"
        and any(ch in "aeiouy" for ch in word[:-1])
    ):
        word = word[:-1]
        if len(word) >= 2 and word[-2] in "aeiou":
            long_idx = len(word) - 2
    phones: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        if i == long_idx:
            phones.append(_LONG_VOWEL[word[i]])
            i += 1
            continue
        for graph, ipa in _ENG_RULES:
            if word.startswith(graph, i):
                phones.extend(ipa)
                i += len(graph)
                break
        else:
            # unknown character (digit, symbol): pass through as itself
            phones.append(word[i])
            i += 1
    return phones


def english_g2p(text: str) -> List[str]:
    """English text → IPA phone tokens; spaces and punctuation pass through
    as their own tokens (punctuation is class-normalized downstream)."""
    text = unicodedata.normalize("NFC", text).lower()
    out: List[str] = []
    word = ""
    for ch in text:
        if ch.isalpha() or ch == "'":
            if ch != "'":
                word += ch
            continue
        if word:
            out.extend(_eng_word(word))
            word = ""
        if ch.isspace():
            if out and out[-1] != " ":
                out.append(" ")
        else:
            out.append(ch)
    if word:
        out.extend(_eng_word(word))
    while out and out[0] == " ":
        out.pop(0)
    while out and out[-1] == " ":
        out.pop()
    return out


def characters_g2p(text: str) -> List[str]:
    """Identity engine for (near-)phonemic orthographies: every NFC character
    is one phone token."""
    return list(unicodedata.normalize("NFC", text).lower())


# Every IPA symbol the bundled engines can emit — injected into the symbol
# inventory when a phones-level model has no user-declared phone set.
# Includes the lexicon's reduced vowel (ə) and stress token (ˈ).
def _lexicon_phones() -> set:
    from .lexicon import ENGLISH_LEXICON

    phones = set()
    for entry in ENGLISH_LEXICON.values():
        for tok in entry.split(" "):
            if len(tok) > 1 and tok.startswith("ˈ"):
                phones.add("ˈ")
                phones.add(tok[1:])
            else:
                phones.add(tok)
    return phones


IPA_PHONES: List[str] = sorted(
    {p for _, seq in _ENG_RULES for p in seq}
    | set(ARPABET_TO_IPA.values())
    | _lexicon_phones(),
    key=lambda s: (-len(s), s),
)

_ENGLISH_CODES = {"eng", "en", "english", "en-us", "en-gb"}

BUNDLED_ENGINES: dict[str, Callable[[str], List[str]]] = {
    "english": english_g2p,
    "characters": characters_g2p,
}

_warned_langs: set[str] = set()


def get_g2p_engine(language: str) -> Optional[Callable[[str], List[str]]]:
    """Bundled engine for a language code: English rules for English codes,
    character passthrough (with a one-time log) otherwise."""
    lang = (language or "default").lower()
    if lang in _ENGLISH_CODES:
        return english_g2p
    if lang not in _warned_langs:
        _warned_langs.add(lang)
        logger.info(
            "No bundled g2p rules for language %r — using character "
            "passthrough (configure text.g2p_engines for a custom engine).",
            language,
        )
    return characters_g2p
