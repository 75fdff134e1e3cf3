"""Phonological feature vectors for the 'phonological_features' text
representation (a copy of the JAX package's ``text/features.py``; it
re-provides everyvoice.text.features.N_PHONOLOGICAL_FEATURES, used by the
bias-free Linear text input layer, fs2/model.py:72-81).

The feature space is panphon's: 24 ternary features (+1/-1/0) in panphon's
ipa_all.csv column order. Two sources feed it, in priority order:

1. **Installed panphon** (`import panphon`) — exact numerical compatibility
   with reference pfs checkpoints (everyvoice's pfs space is panphon-derived).
   Environments that have it get it automatically.
2. **Bundled table** — segments are generated by articulatory constructors
   following panphon's Hayes-based conventions (vowels/stops/fricatives/
   nasals/liquids/glides with per-place and per-height settings; velaric −1
   everywhere except clicks; tone features 0 without tone marks; long +1 only
   under 'ː'). Covers the full inventory the bundled g2p emits plus the
   common IPA consonant/vowel core. Values were written to panphon's
   published conventions but are not machine-checked against ipa_all.csv in
   this repository — treat cross-loading pfs checkpoints WITHOUT panphon
   installed as approximate.

Unknown symbols (punctuation tokens, pad) map to the zero vector.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# panphon ipa_all.csv column order (panphon >= 0.19: 22 Hayes features + the
# two tone features)
FEATURE_NAMES = [
    "syl", "son", "cons", "cont", "delrel", "lat", "nas", "strid", "voi",
    "sg", "cg", "ant", "cor", "distr", "lab", "hi", "lo", "back", "round",
    "velaric", "tense", "long", "hitone", "hireg",
]

N_PHONOLOGICAL_FEATURES = len(FEATURE_NAMES)


def _seg(**kw) -> Dict[str, int]:
    """Base segment: panphon-style defaults (features are specified, not
    merely absent: velaric −1, tone 0, long −1)."""
    base = dict(
        syl=-1, son=-1, cons=1, cont=-1, delrel=-1, lat=-1, nas=-1, strid=0,
        voi=-1, sg=-1, cg=-1, ant=0, cor=-1, distr=0, lab=-1, hi=-1, lo=-1,
        back=-1, round=-1, velaric=-1, tense=0, long=-1, hitone=0, hireg=0,
    )
    base.update(kw)
    return base


def _vowel(hi=-1, lo=-1, back=-1, rnd=-1, tense=1, **kw) -> Dict[str, int]:
    return _seg(
        syl=1, son=1, cons=-1, cont=1, voi=1, strid=-1,
        hi=hi, lo=lo, back=back, round=rnd, lab=rnd, tense=tense, **kw,
    )


# place helpers (articulator-theory values panphon uses)
_LABIAL = dict(lab=1, ant=1, cor=-1)
_DENTAL = dict(cor=1, ant=1, distr=1)
_ALVEOLAR = dict(cor=1, ant=1, distr=-1)
_POSTALV = dict(cor=1, ant=-1, distr=1)
_RETROFLEX = dict(cor=1, ant=-1, distr=-1)
_PALATAL = dict(cor=-1, hi=1, back=-1)
_VELAR = dict(cor=-1, hi=1, back=1)
_UVULAR = dict(cor=-1, hi=-1, back=1)
_GLOTTAL = dict(cor=-1)


def _stop(place, voiced=False, **kw):
    return _seg(voi=1 if voiced else -1, strid=-1, **place, **kw)


def _fric(place, voiced=False, strident=True, **kw):
    return _seg(
        cont=1, voi=1 if voiced else -1, strid=1 if strident else -1,
        **place, **kw,
    )


def _affr(place, voiced=False, **kw):
    return _seg(
        delrel=1, voi=1 if voiced else -1, strid=1, **place, **kw
    )


def _nasal(place, **kw):
    return _seg(son=1, nas=1, voi=1, strid=-1, **place, **kw)


def _approx(place, lateral=False, **kw):
    return _seg(
        son=1, cont=1, voi=1, strid=-1, lat=1 if lateral else -1,
        **place, **kw,
    )


def _glide(**kw):
    return _seg(syl=-1, son=1, cons=-1, cont=1, voi=1, strid=-1, **kw)


_TABLE: Dict[str, Dict[str, int]] = {
    # ---- vowels (hi, lo, back, round, tense) -----------------------------
    "i": _vowel(hi=1, back=-1),
    "y": _vowel(hi=1, back=-1, rnd=1),
    "ɨ": _vowel(hi=1, back=-1, tense=-1),
    "ʉ": _vowel(hi=1, back=-1, rnd=1, tense=-1),
    "ɯ": _vowel(hi=1, back=1),
    "u": _vowel(hi=1, back=1, rnd=1),
    "ɪ": _vowel(hi=1, back=-1, tense=-1),
    "ʏ": _vowel(hi=1, back=-1, rnd=1, tense=-1),
    "ʊ": _vowel(hi=1, back=1, rnd=1, tense=-1),
    "e": _vowel(),
    "ø": _vowel(rnd=1),
    "ə": _vowel(tense=-1),
    "ɘ": _vowel(tense=-1),
    "ɵ": _vowel(rnd=1, tense=-1),
    "ɤ": _vowel(back=1),
    "o": _vowel(back=1, rnd=1),
    "ɛ": _vowel(tense=-1),
    "œ": _vowel(rnd=1, tense=-1),
    "ɜ": _vowel(tense=-1),
    "ɞ": _vowel(rnd=1, tense=-1),
    "ʌ": _vowel(back=1, tense=-1),
    "ɔ": _vowel(back=1, rnd=1, tense=-1),
    "æ": _vowel(lo=1, back=-1, tense=-1),
    "ɐ": _vowel(lo=1, tense=-1),
    "a": _vowel(lo=1, back=-1),
    "ɶ": _vowel(lo=1, back=-1, rnd=1),
    "ɑ": _vowel(lo=1, back=1),
    "ɒ": _vowel(lo=1, back=1, rnd=1),
    # rhotacized vowels
    "ɝ": _vowel(tense=-1),
    "ɚ": _vowel(tense=-1),
    # ---- stops ------------------------------------------------------------
    "p": _stop(_LABIAL),
    "b": _stop(_LABIAL, voiced=True),
    "t": _stop(_ALVEOLAR),
    "d": _stop(_ALVEOLAR, voiced=True),
    "ʈ": _stop(_RETROFLEX),
    "ɖ": _stop(_RETROFLEX, voiced=True),
    "c": _stop(_PALATAL),
    "ɟ": _stop(_PALATAL, voiced=True),
    "k": _stop(_VELAR),
    "ɡ": _stop(_VELAR, voiced=True),
    "g": _stop(_VELAR, voiced=True),
    "q": _stop(_UVULAR),
    "ɢ": _stop(_UVULAR, voiced=True),
    # glottal stop: a placeless laryngeal — [-consonantal] in the Hayes
    # chart panphon follows (like h/ɦ), unlike every supralaryngeal stop
    "ʔ": _seg(cons=-1, cg=1, strid=-1),
    # ---- nasals -----------------------------------------------------------
    "m": _nasal(_LABIAL),
    "ɱ": _nasal(_LABIAL),
    "n": _nasal(_ALVEOLAR),
    "ɳ": _nasal(_RETROFLEX),
    "ɲ": _nasal(_PALATAL),
    "ŋ": _nasal(_VELAR),
    "ɴ": _nasal(_UVULAR),
    # ---- fricatives ---------------------------------------------------------
    "ɸ": _fric(_LABIAL, strident=False),
    "β": _fric(_LABIAL, voiced=True, strident=False),
    "f": _fric(_LABIAL),
    "v": _fric(_LABIAL, voiced=True),
    "θ": _fric(_DENTAL, strident=False),
    "ð": _fric(_DENTAL, voiced=True, strident=False),
    "s": _fric(_ALVEOLAR),
    "z": _fric(_ALVEOLAR, voiced=True),
    "ʃ": _fric(_POSTALV),
    "ʒ": _fric(_POSTALV, voiced=True),
    "ʂ": _fric(_RETROFLEX),
    "ʐ": _fric(_RETROFLEX, voiced=True),
    "ç": _fric(_PALATAL, strident=False),
    "ʝ": _fric(_PALATAL, voiced=True, strident=False),
    "x": _fric(_VELAR, strident=False),
    "ɣ": _fric(_VELAR, voiced=True, strident=False),
    "χ": _fric(_UVULAR, strident=False),
    "ʁ": _fric(_UVULAR, voiced=True, strident=False),
    "ħ": _fric(_GLOTTAL, strident=False),
    "ʕ": _fric(_GLOTTAL, voiced=True, strident=False),
    "h": _seg(cons=-1, cont=1, sg=1, strid=-1),
    "ɦ": _seg(cons=-1, cont=1, sg=1, voi=1, strid=-1),
    "ɬ": _fric(_ALVEOLAR, strident=False, lat=1),
    "ɮ": _fric(_ALVEOLAR, voiced=True, strident=False, lat=1),
    # ---- affricates ---------------------------------------------------------
    "ts": _affr(_ALVEOLAR),
    "dz": _affr(_ALVEOLAR, voiced=True),
    "tʃ": _affr(_POSTALV),
    "dʒ": _affr(_POSTALV, voiced=True),
    # ---- liquids / approximants ---------------------------------------------
    "l": _approx(_ALVEOLAR, lateral=True),
    "ɭ": _approx(_RETROFLEX, lateral=True),
    "ʎ": _approx(_PALATAL, lateral=True),
    "ʟ": _approx(_VELAR, lateral=True),
    "ɹ": _approx(_ALVEOLAR),
    "ɻ": _approx(_RETROFLEX),
    "r": _approx(_ALVEOLAR),  # trill; panphon adds nothing expressible here
    "ɾ": _approx(_ALVEOLAR),
    "ʙ": _approx(_LABIAL),
    "ʀ": _approx(_UVULAR),
    "ʋ": _glide(lab=1),
    # ---- glides -------------------------------------------------------------
    "j": _glide(hi=1, back=-1, tense=1),
    "ɰ": _glide(hi=1, back=1, tense=1),
    "w": _glide(hi=1, back=1, round=1, lab=1, tense=1),
    "ɥ": _glide(hi=1, back=-1, round=1, lab=1, tense=1),
}

# diphthongs the bundled g2p emits as single tokens: featurized as their
# first element (panphon segments diphthongs; single-token streams can't)
for _diph, _first in (("eɪ", "e"), ("aɪ", "a"), ("ɔɪ", "ɔ"),
                      ("aʊ", "a"), ("oʊ", "o")):
    _TABLE[_diph] = dict(_TABLE[_first])

# length mark modifies the previous segment when tokenized separately
_TABLE["ː"] = {"long": 1}


def _bundled_features(symbol: str) -> np.ndarray:
    vec = np.zeros(N_PHONOLOGICAL_FEATURES, dtype=np.float32)
    feats = _TABLE.get(symbol)
    if feats:
        for name, val in feats.items():
            vec[FEATURE_NAMES.index(name)] = float(val)
    return vec


_panphon_table = None
_panphon_checked = False


def _panphon_features(symbol: str):
    """Exact panphon vector when panphon is installed; None otherwise."""
    global _panphon_table, _panphon_checked
    if not _panphon_checked:
        _panphon_checked = True
        try:
            import panphon

            _panphon_table = panphon.FeatureTable()
        except Exception:
            _panphon_table = None
    if _panphon_table is None:
        return None
    vecs = _panphon_table.word_to_vector_list(symbol, numeric=True)
    if not vecs:
        return None
    vec = np.asarray(vecs[0], dtype=np.float32)
    if len(vec) == N_PHONOLOGICAL_FEATURES:
        return vec
    out = np.zeros(N_PHONOLOGICAL_FEATURES, dtype=np.float32)
    out[: min(len(vec), N_PHONOLOGICAL_FEATURES)] = vec[:N_PHONOLOGICAL_FEATURES]
    return out


def get_features(symbol: str) -> np.ndarray:
    """Feature vector for one symbol; zeros for unknown/pad/punctuation."""
    pp = _panphon_features(symbol)
    if pp is not None:
        return pp
    return _bundled_features(symbol)


def get_features_for_tokens(tokens: List[str]) -> np.ndarray:
    """[T, N_PHONOLOGICAL_FEATURES] matrix for a token sequence."""
    if not tokens:
        return np.zeros((0, N_PHONOLOGICAL_FEATURES), dtype=np.float32)
    return np.stack([get_features(t) for t in tokens])
