"""The port's synthesis writers and data preparation against the JAX
package's, on the CPU.

The same made-up model outputs and batches (two batches; the first
utterance's three chunks straddle them, so each writer reassembles it across
batches) go through the JAX writers and the port's, each set into its own
folder: the same file names, TextGrid, ``.readalong`` and ``.html`` files
byte-equal, ``.npy`` specs and PCM16 wavs equal. Both factories refuse wav
and readalong-html output without a vocoder with the same error.
``prepare_data`` gives equal items (texts, long text that chunks, psv and
plain filelists, no chunking) and equal errors (languages and speakers the
model lacks), and so does ``validate_data_keys_with_model_keys``."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest

from fastspeech2_lightning_tpu.config import DatasetTextRepresentation
from fastspeech2_lightning_tpu.synthesis import prepare as jprepare
from fastspeech2_lightning_tpu.synthesis.writers import (
    get_synthesis_output_writers as j_get_writers,
)
from fastspeech2_lightning_tpu.testing import stub_config
from fastspeech2_lightning_tpu.type_definitions import (
    SynthesizeOutputFormats as JFormats,
)
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.synthesis import prepare
from fastspeech2_lightning_tpu_torch.synthesis.writers import get_synthesis_output_writers
from fastspeech2_lightning_tpu_torch.text import TextProcessor
from fastspeech2_lightning_tpu_torch.type_definitions import Stats, SynthesizeOutputFormats

from helpers import tiny_stats

FORMATS = ("wav", "spec", "textgrid", "readalong-xml", "readalong-html")
N_MELS = 20
# (raw text, speaker, language, is_last_input_chunk): utterance one in three
# chunks across the two batches, then a one-chunk utterance
ROWS = [("hello there, ", "default", "default", False),
        ("my \"dear\" friend & ", "default", "default", False),
        ("how are you?", "default", "default", True),
        ("fine thanks", "default", "default", True)]
BATCHES = ((0, 2), (2, 4))


def _configs():
    jcfg = stub_config(dtype="float32")
    return jcfg, FastSpeech2Config.from_dict(jcfg.model_checkpoint_dump())


def _fake_batches(config, seed=0):
    """(outputs, batch) pairs as ``synthesize_items`` hands them over: the
    text padded to 16, log-durations per symbol, a mel padded past the
    frames the durations give."""
    rng = np.random.default_rng(seed)
    tp = TextProcessor(config.text)
    pairs = []
    for lo, hi in BATCHES:
        rows = ROWS[lo:hi]
        ids = [tp.encode_text(r[0]) for r in rows]
        B, L = len(rows), 32
        text = np.zeros((B, L), np.int32)
        for i, e in enumerate(ids):
            text[i, : len(e)] = e
        src_lens = np.array([len(e) for e in ids], np.int32)
        log_d = rng.uniform(0.5, 2.5, (B, L)).astype(np.float32)
        frames = np.clip(np.round(np.exp(log_d) - 1), 0, None).astype(int)
        tgt_lens = np.array([frames[i, : src_lens[i]].sum() for i in range(B)], np.int32)
        T = int(tgt_lens.max()) + 40
        mel = rng.standard_normal((B, T, N_MELS)).astype(np.float32) - 3.0
        outputs = {"postnet_output": mel, "output": mel + 1.0, "tgt_lens": tgt_lens,
                   "duration_prediction": log_d}
        batch = {"text": text, "src_lens": src_lens, "raw_text": [r[0] for r in rows],
                 "speaker": [r[1] for r in rows], "language": [r[2] for r in rows],
                 "is_last_input_chunk": [r[3] for r in rows],
                 "duration_control": np.full(B, 1.25, np.float32)}
        pairs.append((outputs, batch))
    return pairs


def _vocoder(mel):
    """A made-up vocoder: 256 samples a frame, amplitude from the mel."""
    mel = np.asarray(mel)
    t = np.arange(256) / 256.0
    frames = np.tanh(mel.mean(-1, keepdims=True) / 4.0) * np.sin(2 * np.pi * 3 * t)
    return frames.reshape(mel.shape[0], -1).astype(np.float32), 22050


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    jcfg, cfg = _configs()
    roots = {}
    for name, factory, formats, config in (
            ("jax", j_get_writers, [JFormats(f) for f in FORMATS], jcfg),
            ("port", get_synthesis_output_writers,
             [SynthesizeOutputFormats(f) for f in FORMATS], cfg)):
        root = tmp_path_factory.mktemp(name)
        writers = factory(formats, root, config, "postnet_output", 7, vocoder=_vocoder,
                          vocoder_global_step=3, output_hop_size=256)
        for outputs, batch in _fake_batches(cfg):
            for w in writers.values():
                w.on_predict_batch_end(outputs, batch)
        roots[name] = root
    return _files(roots["jax"]), _files(roots["port"])


def test_same_file_names(written):
    want, got = written
    assert sorted(got) == sorted(want)
    # one file per utterance and format: chunks were reassembled
    assert len(got) == 2 * len(FORMATS)
    assert any("ckpt=7--v_ckpt=3--pred.wav" in name for name in got)


@pytest.mark.parametrize("suffix", [".TextGrid", ".readalong", ".html", ".npy", ".wav"])
def test_files_equal(written, suffix):
    want, got = written
    names = [n for n in want if n.endswith(suffix)]
    assert len(names) == 2
    for name in names:
        assert got[name].read_bytes() == want[name].read_bytes(), name


def test_reassembled_lengths(written):
    _, got = written
    cfg = _configs()[1]
    pairs = _fake_batches(cfg)
    lens = np.concatenate([o["tgt_lens"] for o, _ in pairs])
    spec = [np.load(p) for n, p in got.items() if n.endswith(".npy") and "hello" in n][0]
    assert spec.shape == (N_MELS, int(lens[:3].sum()))


@pytest.mark.parametrize("fmt", ["wav", "readalong-html"])
def test_no_vocoder_same_error(tmp_path, fmt):
    jcfg, cfg = _configs()
    with pytest.raises(ValueError) as want:
        j_get_writers([JFormats(fmt)], tmp_path / "j", jcfg, "output", 0)
    with pytest.raises(ValueError) as got:
        get_synthesis_output_writers([SynthesizeOutputFormats(fmt)], tmp_path / "p", cfg,
                                     "output", 0)
    assert str(got.value) == str(want.value)


LONG = ("It was the best of times, it was the worst of times. It was the age of wisdom, "
        "it was the age of foolishness! It was the epoch of belief; it was the epoch of "
        "incredulity, it was the season of light: it was the season of darkness. ") * 2


def _filelist(tmp_path: Path, kind: str) -> Path:
    if kind == "psv":
        path = tmp_path / "list.psv"
        path.write_text("basename|speaker|language|characters\n"
                        "u1|default|default|hello world\n"
                        f"u2|default|default|{LONG}\n")
    else:
        path = tmp_path / "list.txt"
        path.write_text("hello world\n\nsecond line, here.\n")
    return path


CASES = {
    "texts": dict(texts=["hello world", "abc"]),
    "long text": dict(texts=[LONG], duration_control=1.5),
    "long text unsplit": dict(texts=[LONG], split_text=False),
    "psv filelist": dict(filelist="psv"),
    "plain filelist": dict(filelist="txt"),
    "speaker the model lacks": dict(texts=["abc"], speaker="bob"),
    "language the model lacks": dict(texts=["abc"], language="fr"),
    "multispeaker without a speaker": dict(texts=["abc"], multispeaker=True,
                                           speaker2id={}),
    "multilingual, unknown language": dict(texts=["abc"], multilingual=True,
                                           language="fr"),
}


def _prepare(fn, config, stats, rep, kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            return fn(config=config, stats=stats, text_representation=rep, **kw), err.getvalue()
        except ValueError as e:
            return ("ValueError", str(e)), err.getvalue()


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_data_equal(tmp_path, case):
    kw = dict(CASES[case])
    jcfg, cfg = _configs()
    for flag in ("multispeaker", "multilingual"):
        value = kw.pop(flag, False)
        setattr(jcfg.model, flag, value)
        setattr(cfg.model, flag, value)
    jstats = tiny_stats()
    stats = Stats.from_dict(jstats.model_dump())
    args = dict(texts=None, language=None, speaker=None, filelist=None,
                lang2id={"default": 0}, speaker2id={"default": 0})
    args.update(kw)
    if args["filelist"] is not None:
        args["filelist"] = _filelist(tmp_path, args["filelist"])
    want = _prepare(jprepare.prepare_data, jcfg, jstats, DatasetTextRepresentation.characters,
                    args)
    got = _prepare(prepare.prepare_data, cfg, stats, "characters", args)
    assert got == want
    # the last four cases are refused
    assert (got[0][0] == "ValueError") == (list(CASES).index(case) >= 5)
    if case == "long text":
        assert len(got[0]) > 2 and [i["is_last_input_chunk"] for i in got[0]][-2:] == [
            False, True]


@pytest.mark.parametrize("data_keys, model_keys, key, multi", [
    ({"default"}, {"default"}, "speaker", False),
    ({"bob", None}, {"default"}, "speaker", False),
    ({"fr"}, set(), "language", False),
    ({None}, {"en", "fr"}, "language", True),
    ({"de"}, {"en", "fr"}, "language", True),
    ({"en"}, {"en", "fr"}, "language", True),
])
def test_validate_keys_equal(data_keys, model_keys, key, multi):
    results = []
    for fn in (jprepare.validate_data_keys_with_model_keys,
               prepare.validate_data_keys_with_model_keys):
        try:
            results.append(fn(data_keys, model_keys, key, multi))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]
