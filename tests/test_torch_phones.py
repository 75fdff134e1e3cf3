"""Phone and phonological-feature inputs in the PyTorch port against the JAX
package, on the CPU.

Exactly equal to the JAX functions: the g2p engines (English rules and
lexicon, character passthrough, ARPABET), ``IPA_PHONES`` and the engine
lookup; the lexicon; the feature vector of every IPA phone and of tokens the
table lacks; the symbol table a phone-level or phonological-feature config
gets (``g2p_ipa`` injected) and the one a character config keeps;
``Preprocessor.process_text`` on phones, arpabet and g2p items (bundled
names, a dotted path, the default engine per language); and
``encode_texts_for_model``'s ids and features. A phone-level and a
phonological-feature FastSpeech2 from the JAX init: the inference forward
within 1e-5 of the JAX output's largest magnitude, durations equal. The
port's ``Synthesizer`` on stubbed phone and pfs checkpoints against JAX's
(durations equal, mels within 1e-4). A phonological-feature corpus (half its
items with ``phone_tokens``, half encoded by g2p, ``pfs.npy`` beside them):
the port's bucketed batches equal the JAX loader's. The CLI's
``--text-representation`` usage errors are the JAX CLI's, and an arpabet
input to a phone model gives the JAX CLI's spec within 1e-4."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu.config import FastSpeech2Config as JConfig
from fastspeech2_lightning_tpu.dataset import BucketedLoader as JBucketedLoader
from fastspeech2_lightning_tpu.dataset import FastSpeechDataset as JFastSpeechDataset
from fastspeech2_lightning_tpu.models import FastSpeech2 as JFastSpeech2
from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.preprocessing.pipeline import Preprocessor as JPreprocessor
from fastspeech2_lightning_tpu.synthesis.api import Synthesizer as JSynthesizer
from fastspeech2_lightning_tpu.synthesis.prepare import (
    encode_texts_for_model as j_encode_texts_for_model,
)
from fastspeech2_lightning_tpu.testing import get_stubbed_model, stub_config
from fastspeech2_lightning_tpu.text import TextProcessor as JTextProcessor
from fastspeech2_lightning_tpu.text import features as j_features
from fastspeech2_lightning_tpu.text import g2p as j_g2p
from fastspeech2_lightning_tpu.text import lexicon as j_lexicon
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.convert import state_dict_from_jax
from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, FastSpeechDataset
from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import Preprocessor
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.synthesis.prepare import encode_texts_for_model
from fastspeech2_lightning_tpu_torch.text import TextProcessor
from fastspeech2_lightning_tpu_torch.text import features, g2p, lexicon

from helpers import synthetic_batch, tiny_config, tiny_stats

torch.set_num_threads(2)
REL = 1e-5
SPEC_ATOL = 1e-4
PHONES, PFS = "phones", "phonological_features"
SENTENCES = [
    "Hello world, how are you today?",
    "The quick brown fox jumps over the lazy dog.",
    "Shape, knight, thought; whistle and rhythm!",
    "It's the station's 42nd anniversary: don't panic.",
    "Queen Xavier's wreath, caught in the eighth rough squall.",
]
ARPABET = ["HH AH0 L OW1 W ER1 L D", "DH AH0 K W IH1 K B R AW1 N F AA1 K S",
           ["T", "EH1", "S", "T", "", "AH0", "B", "AW1", "T"]]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- g2p, lexicon, features ------------------------------------------------------


@pytest.mark.parametrize("sentence", SENTENCES)
def test_english_and_character_g2p_equal_jax(sentence):
    assert g2p.english_g2p(sentence) == j_g2p.english_g2p(sentence)
    assert g2p.characters_g2p(sentence) == j_g2p.characters_g2p(sentence)


@pytest.mark.parametrize("arpabet", ARPABET, ids=["hello", "quick", "list"])
def test_arpabet_to_ipa_equals_jax(arpabet):
    assert g2p.arpabet_to_ipa(arpabet) == j_g2p.arpabet_to_ipa(arpabet)


def test_inventory_tables_and_engines_equal_jax():
    assert g2p.IPA_PHONES == j_g2p.IPA_PHONES
    assert g2p.ARPABET_TO_IPA == j_g2p.ARPABET_TO_IPA
    assert sorted(g2p.BUNDLED_ENGINES) == sorted(j_g2p.BUNDLED_ENGINES)
    for code in ("eng", "EN-us", "english", "fra", "default", ""):
        assert g2p.get_g2p_engine(code).__name__ == j_g2p.get_g2p_engine(code).__name__
    assert lexicon.ENGLISH_LEXICON == j_lexicon.ENGLISH_LEXICON
    for word in ("the", "one", "dont", "different", "zzyzx"):
        assert lexicon.lookup(word) == j_lexicon.lookup(word)


def test_features_equal_jax():
    assert features.N_PHONOLOGICAL_FEATURES == j_features.N_PHONOLOGICAL_FEATURES == 24
    assert features.FEATURE_NAMES == j_features.FEATURE_NAMES
    symbols = list(g2p.IPA_PHONES) + ["ː", "ʙ", "ɥ", " ", ",", "<EXCL>", "\x80", "q̃"]
    for s in symbols:
        np.testing.assert_array_equal(features.get_features(s), j_features.get_features(s),
                                      err_msg=repr(s))
    np.testing.assert_array_equal(features.get_features_for_tokens(symbols),
                                  j_features.get_features_for_tokens(symbols))
    assert features.get_features_for_tokens([]).shape == (0, 24)


# -- configs, process_text, encode_texts_for_model -------------------------------


def _raw_config(level, symbols=None, g2p_engines=None):
    return {
        "model": {"target_text_representation_level": level},
        "text": {"symbols": symbols or {"letters": list("abcdefghijklmnopqrstuvwxyz"),
                                        "punctuation": list(",.?!;:'")},
                 **({"g2p_engines": g2p_engines} if g2p_engines else {})},
    }


SYMBOL_CASES = {
    "characters": (_raw_config("characters"), False),
    "phones": (_raw_config(PHONES), True),
    "pfs": (_raw_config(PFS), True),
    "phones_with_declared_phones": (_raw_config(PHONES, {"letters": list("abc"),
                                                         "mine": ["ʃ", "ŋ", "aɪ"]}), True),
    "phones_with_its_own_g2p_ipa": (_raw_config(PHONES, {"g2p_ipa": ["a", "b"]}), False),
}


@pytest.mark.parametrize("case", list(SYMBOL_CASES))
def test_symbol_table_equals_jax(case):
    raw, injected = SYMBOL_CASES[case]
    declared = dict(raw["text"]["symbols"])
    jcfg = JConfig.model_validate(raw)
    cfg = FastSpeech2Config.from_dict(raw)
    assert raw["text"]["symbols"] == declared  # the given dict is left as it was
    assert cfg.text.symbols == jcfg.text.symbols
    assert ("g2p_ipa" in cfg.text.symbols) == (injected or "g2p_ipa" in declared)
    assert TextProcessor(cfg.text).symbols == JTextProcessor(jcfg.text).symbols
    # a checkpoint's dumped config loads to the same table
    again = FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())
    assert TextProcessor(again.text).symbols == JTextProcessor(jcfg.text).symbols


ITEMS = {
    "phones_column": {"text": "ignored", "phones": "h ɛ l oʊ , w ɝ l d"},
    "arpabet_column": {"text": "ignored", "arpabet": ARPABET[0]},
    "english_g2p": {"text": SENTENCES[2], "language": "eng"},
    "other_language_passthrough": {"text": "kiaora whanau", "language": "mri"},
    "no_language": {"text": SENTENCES[0]},
}
ENGINES = {
    "default_engines": None,
    "bundled_names": {"eng": "characters", "default": "english"},
    "dotted_path": {"default": "fastspeech2_lightning_tpu_torch.text.g2p.english_g2p"},
}


def _pair(level, engines=None):
    raw = _raw_config(level, g2p_engines=engines)
    return FastSpeech2Config.from_dict(raw), JConfig.model_validate(raw)


@pytest.mark.parametrize("engines", list(ENGINES))
@pytest.mark.parametrize("item", list(ITEMS))
def test_process_text_equals_jax(item, engines):
    cfg, jcfg = _pair(PHONES, ENGINES[engines])
    got = Preprocessor(cfg).process_text(dict(ITEMS[item]), use_pfs=True)
    want = JPreprocessor(jcfg).process_text(dict(ITEMS[item]), use_pfs=True)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[1]  # phones found
    np.testing.assert_array_equal(got[2], want[2])


def test_process_text_on_a_character_model_runs_no_g2p():
    cfg, jcfg = _pair("characters")
    item = {"text": SENTENCES[1], "language": "eng"}
    assert Preprocessor(cfg).process_text(item)[1] is None
    assert JPreprocessor(jcfg).process_text(item)[1] is None


@pytest.mark.parametrize("level", ["characters", PHONES, PFS])
@pytest.mark.parametrize("language", [None, "eng", "fra"])
def test_encode_texts_for_model_equals_jax(level, language):
    cfg, jcfg = _pair(level)
    ids, pfs = encode_texts_for_model(SENTENCES, language, cfg, TextProcessor(cfg.text), {})
    jids, jpfs = j_encode_texts_for_model(SENTENCES, language, jcfg, JTextProcessor(jcfg.text),
                                          {})
    for a, b in zip(ids, jids):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and len(a) > 0
    assert (pfs is None) == (jpfs is None) == (level != PFS)
    for i, (a, b) in enumerate(zip(pfs or [], jpfs or [])):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (len(ids[i]), 24)


# -- models ----------------------------------------------------------------------


def _model_pair(level):
    jcfg = tiny_config(dtype="float32", target_text_representation_level=level)
    stats = tiny_stats()
    n_symbols = len(JTextProcessor(jcfg.text).symbols)
    jmodel = JFastSpeech2(config=jcfg, stats=stats, n_symbols=n_symbols)
    batch = synthetic_batch(np.random.default_rng(0), B=3, L=12, T=48, n_symbols=n_symbols)
    batch["pfs"] = np.random.default_rng(1).choice(
        [-1.0, 0.0, 1.0], size=(3, 12, 24)).astype(np.float32)
    variables = jax.jit(lambda b: jmodel.init({"params": jax.random.PRNGKey(0),
                                               "dropout": jax.random.PRNGKey(1)}, b))(batch)
    vp = jcfg.model.variance_predictors
    constants = {"variance_adaptor": {
        k: jnp.linspace(-2.0, 2.0, getattr(vp, k.split("_")[0]).n_bins - 1)
        for k in ("pitch_bins", "energy_bins")}}
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                 "constants": constants}
    sd = state_dict_from_jax(*(jax.tree_util.tree_map(np.asarray, variables[k])
                               for k in ("params", "batch_stats", "constants")), jcfg, stats)
    cfg = FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())
    model = FastSpeech2(cfg, n_symbols=n_symbols)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    infer = {k: batch[k] for k in ("text", "src_lens", "speaker_id", "language_id", "pfs")}
    want = jax.jit(lambda v, b: jmodel.apply(v, b, inference=True, deterministic=True,
                                             max_target_len=64))(variables, infer)
    return model.eval(), infer, want


@pytest.mark.parametrize("level", [PHONES, PFS])
def test_phone_and_pfs_forwards_match_jax(level):
    model, b, want = _model_pair(level)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    out = model(t["text"].long(), t["src_lens"].long(), 64, speaker_id=t["speaker_id"].long(),
                language_id=t["language_id"].long(), pfs=t["pfs"])
    np.testing.assert_array_equal(out["duration_rounded"].numpy(),
                                  np.asarray(want["duration_rounded"]))
    assert _rel(out["output"].numpy(), want["output"]) <= REL
    if level == PFS:
        assert tuple(model.text_input_layer.weight.shape) == (32, 24)
        assert model.text_input_layer.bias is None
        with pytest.raises(ValueError, match="pfs"):
            model(t["text"].long(), t["src_lens"].long(), 64)


@pytest.fixture(scope="module")
def stubbed(tmp_path_factory):
    """level -> (orbax directory, exported .ckpt) of a stubbed model."""
    out = {}
    for level in (PHONES, PFS):
        tmp = tmp_path_factory.mktemp(level)
        config = stub_config(dtype="float32", target_text_representation_level=level)
        _, orbax_dir = get_stubbed_model(tmp / "model", config=config)
        out[level] = orbax_dir, export_reference_lightning_checkpoint(orbax_dir,
                                                                      tmp / "model.ckpt")
    return out


@pytest.mark.parametrize("level", [PHONES, PFS])
def test_synthesizer_matches_jax(stubbed, level):
    orbax_dir, ckpt = stubbed[level]
    want = JSynthesizer.from_checkpoint(orbax_dir).synthesize(SENTENCES[:3])
    got = Synthesizer.from_checkpoint(ckpt, device="cpu").synthesize(SENTENCES[:3])
    for j, p in zip(want.durations, got.durations):
        np.testing.assert_array_equal(p, j)
    for j, p in zip(want.mels, got.mels):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, rtol=0, atol=SPEC_ATOL)


def _port_cli(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            cli.main(argv)
        except SystemExit as e:
            return e.code, err.getvalue()
    return 0, err.getvalue()


def test_arpabet_input_to_a_phone_model_matches_the_jax_cli(stubbed, tmp_path):
    orbax_dir, ckpt = stubbed[PHONES]
    args = ["-t", ARPABET[0], "--text-representation", "arpabet", "-O", "spec"]
    res = CliRunner().invoke(jax_app, ["synthesize", str(orbax_dir), *args, "-o",
                                       str(tmp_path / "jax")], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    code, err = _port_cli(["synthesize", str(ckpt), *args, "-o", str(tmp_path / "port"),
                           "--device", "cpu"])
    assert code == 0, err
    want = sorted((tmp_path / "jax").rglob("*.npy"))
    got = sorted((tmp_path / "port").rglob("*.npy"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 1
    np.testing.assert_allclose(np.load(got[0]), np.load(want[0]), rtol=0, atol=SPEC_ATOL)


@pytest.fixture(scope="module")
def character_stub(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chars")
    _, orbax_dir = get_stubbed_model(tmp / "model", config=stub_config(dtype="float32"))
    return tmp, orbax_dir, export_reference_lightning_checkpoint(orbax_dir, tmp / "m.ckpt")


@pytest.mark.parametrize("representation", ["phones", "arpabet"])
def test_text_representation_usage_errors_match_the_jax_cli(character_stub, representation):
    tmp, orbax_dir, ckpt = character_stub
    args = ["-t", "abc", "-O", "spec", "--text-representation", representation]
    res = CliRunner().invoke(jax_app, ["synthesize", str(orbax_dir), *args])
    assert res.exit_code == 2
    message = res.output.split("Error: ", 1)[1].strip()
    code, err = _port_cli(["synthesize", str(ckpt), *args, "-o", str(tmp / "usage"),
                           "--device", "cpu"])
    assert code == 2
    assert " ".join(err.split()).endswith("error: " + " ".join(message.split())), err


# -- a phonological-feature corpus through the loaders ---------------------------


@pytest.fixture(scope="module")
def pfs_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    raw = _raw_config(PFS)
    jcfg = JConfig.model_validate(raw)
    jcfg.preprocessing.save_dir = root
    jcfg.preprocessing.audio.n_mels = 20
    pre, tp = JPreprocessor(jcfg), JTextProcessor(jcfg.text)
    rng = np.random.default_rng(3)
    words = " ".join(SENTENCES).lower().replace(",", "").replace(".", "").split()
    items = []
    for i in range(12):
        text = " ".join(rng.choice(words, size=int(rng.integers(2, 7))))
        item = {"basename": f"u{i}", "speaker": "default", "language": "eng",
                "characters": text}
        _, phones, pfs = pre.process_text(item, use_pfs=True)
        if i % 2 == 0:  # the other half is encoded by g2p on the fly
            item["phone_tokens"] = "/".join(phones)
        L, T = len(tp.encode_tokens(phones)), int(rng.integers(30, 120))
        stem = f"u{i}--default--eng--"
        arrays = {"spec": ("spec-22050-mel-librosa.npy", rng.standard_normal((20, T))),
                  "attn": ("phones-attn-prior.npy", rng.random((T, L))),
                  "pitch": ("pitch.npy", rng.standard_normal(T)),
                  "energy": ("energy.npy", rng.random(T)),
                  "pfs": ("pfs.npy", pfs)}
        for kind, (name, arr) in arrays.items():
            (root / kind).mkdir(exist_ok=True)
            np.save(root / kind / (stem + name), np.asarray(arr, np.float32))
        items.append(item)
    dump = jcfg.model_checkpoint_dump()
    dump["preprocessing"]["save_dir"] = str(root)
    return items, jcfg, FastSpeech2Config.from_dict(dump)


def test_pfs_training_batches_equal_the_jax_loader(pfs_corpus):
    items, jcfg, cfg = pfs_corpus
    lookups = ({"eng": 0}, {"default": 0})
    want = list(JBucketedLoader(JFastSpeechDataset(items, jcfg, *lookups), batch_size=4,
                                n_buckets=2, seed=5))
    got = list(BucketedLoader(FastSpeechDataset(items, cfg, *lookups), batch_size=4,
                              n_buckets=2, seed=5))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        for key in ("text", "src_lens", "mel", "mel_lens", "pitch", "energy", "attn_prior",
                    "pfs", "sample_weight", "speaker_id", "language_id"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert g["basename"] == w["basename"]
        assert g["pfs"].shape[2] == 24 and np.abs(g["pfs"]).sum() > 0
