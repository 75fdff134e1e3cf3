"""The traffic generators: the same seed gives the same inputs, every seed
the same sizes, and the sizes follow the stated distributions."""

from __future__ import annotations

import math

import numpy as np

from benchmark.common import corpus, harness
from benchmark.traffic import http_open_loop, vocoder_train


def test_acoustic_sizes_fixed_and_in_range():
    sizes = corpus.acoustic_sizes(768, (20, 190), (5.0, 7.0), 947)
    assert sizes == corpus.acoustic_sizes(768, (20, 190), (5.0, 7.0), 947)
    chars = np.array([c for c, _ in sizes])
    frames = np.array([t for _, t in sizes])
    assert chars.min() >= 20 and chars.max() <= 190 and abs(chars.mean() - 105) < 5
    assert frames.max() == 947 and np.all(frames <= np.minimum(chars * 7, 947) + 1)
    assert np.all(frames >= np.minimum(chars * 5, 947) - 1)


def test_acoustic_corpus_deterministic(tmp_path):
    sizes = corpus.acoustic_sizes(6, (10, 20), (5.0, 7.0), 100)
    a = corpus.write_acoustic_corpus(tmp_path / "a", 2 ** 33 + 1, sizes, 8, "spec.npy")
    b = corpus.write_acoustic_corpus(tmp_path / "b", 2 ** 33 + 1, sizes, 8, "spec.npy")
    c = corpus.write_acoustic_corpus(tmp_path / "c", 7, sizes, 8, "spec.npy")
    assert a == b and a != c
    assert sorted(map(len, a)) == sorted(map(len, c)) == sorted(n for n, _ in sizes)
    ua = corpus.read_utterance(tmp_path / "a", "utt0000", "spec.npy")
    ub = corpus.read_utterance(tmp_path / "b", "utt0000", "spec.npy")
    assert all(np.array_equal(ua[k], ub[k]) for k in ua)
    assert ua["attn_prior"].shape == (ua["mel"].shape[0], len(a[0]))


def test_text_batches():
    a = corpus.text_batches(5, 8, 16, (20, 190))
    assert a == corpus.text_batches(5, 8, 16, (20, 190))
    b = corpus.text_batches(6, 8, 16, (20, 190))
    la = sorted(len(t) for batch in a for t in batch)
    assert la == sorted(len(t) for batch in b for t in batch) and a != b
    assert la[0] >= 20 and la[-1] <= 190
    assert len({tuple(sorted(map(len, batch))) for batch in a + b}) > 8  # lengths of their own
    big = [len(t) for batch in corpus.text_batches(7, 64, 16, (20, 190)) for t in batch]
    assert abs(np.mean(big) - 105) < 3 and np.std(big) > 45  # uniform on [20, 190]
    assert all(set(t) <= set(corpus.LETTERS + [" "]) for batch in a for t in batch)


def test_serving_schedule():
    p = harness.load_cell("serve.fs2-espnet-v1.poisson").params
    texts, due = http_open_loop.schedule(11, p, 30.0)
    assert (texts, due) == http_open_loop.schedule(11, p, 30.0)
    other, due2 = http_open_loop.schedule(12, p, 30.0)
    def gaps(d):
        return sorted(np.append(np.diff(d), 30.0 - d[-1]).round(9))

    assert sorted(map(len, texts)) == sorted(map(len, other)) and gaps(due) == gaps(due2)
    assert len(texts) == round(p["rate"] * 30.0) and due[0] == 0.0 and due[-1] < 30.0
    lengths = np.array([len(t) for t in texts])
    assert lengths.min() >= p["chars"][0] and lengths.max() <= p["chars"][1]
    assert abs(np.median(lengths) - p["median_chars"]) < 0.25 * p["median_chars"]
    gaps = np.diff(due)
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.25  # exponential gaps


def test_vocoder_sizes():
    sizes = vocoder_train.wav_sizes(64, (2.0, 10.0), 22050)
    assert sizes == vocoder_train.wav_sizes(64, (2.0, 10.0), 22050)
    assert min(sizes) >= 2 * 22050 and max(sizes) <= 10 * 22050
    assert abs(np.mean(sizes) / 22050 - 6.0) < 1.0


def test_encode_matches_the_inventory():
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.text import TextProcessor

    cfg = harness.load_cell("train.fs2-default.b48-k4").config
    tp = TextProcessor(FastSpeech2Config.from_dict(
        {k: cfg[k] for k in ("model", "preprocessing", "text", "training")}).text)
    text = corpus.text_of_length(np.random.default_rng(3), 150)
    assert list(tp.encode_text(text)) == corpus.encode(text)
    assert len(tp.symbols) == corpus.n_symbols()
    assert math.isclose(len(text), 150)


def test_served_durations_do_not_follow_the_seed():
    import torch

    from benchmark.common import acoustic, serving

    from ._tiny import tiny_cell

    cfg = tiny_cell("synth.fs2-espnet-v1.b16").config
    dev = torch.device("cpu")
    (pa, ba, _), (pb, bb, _) = (serving.acoustic_weights(cfg, s, dev) for s in (11, 12))
    fixed = [k for k in pa if acoustic.on_duration_path(k)]
    assert any(k.startswith("encoder.") for k in fixed) and any("duration" in k for k in fixed)
    assert all(torch.equal(pa[k], pb[k]) for k in fixed)
    assert all(torch.equal(ba[k], bb[k]) for k in ba if acoustic.on_duration_path(k))
    assert not torch.equal(pa["mel_linear.weight"], pb["mel_linear.weight"])
