"""Low-latency streaming in the PyTorch port against the JAX package, on the
CPU.

``windowed_vocode`` on the JAX stub vocoder's ``.npz`` (the port loads it
with its own loader): every segment within 2e-5 of JAX's, for a short mel
(one call at a 32-frame bucket), a mel one frame longer than window + 2 *
margin, and windows of 64 and 128; the concatenation within 2e-5 of the
whole-mel vocoding, while ``margin=0`` visibly differs (as in JAX). A
generator with an MRF stage at a kernel width (C = 32), fused, streams what
it vocodes whole. ``Synthesizer.synthesize_stream`` equals per-mel vocoding
and JAX's stream. The server's ``low_latency`` body has the batched wav's
length and equals it within 2 PCM16 steps away from each chunk's last
`margin` frames (see the test); a window outside [1, 1024] or not an int is a 400;
windows are rounded up to multiples of 64 in [64, 1024]; the counter counts;
a failure before the first window is a 400 and one after it ends the body
short."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from fastspeech2_lightning_tpu.models.hifigan import init_random_hifigan
from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.synthesis.api import Synthesizer as JSynthesizer
from fastspeech2_lightning_tpu.synthesis.streaming import windowed_vocode as j_windowed_vocode
from fastspeech2_lightning_tpu.testing import get_stubbed_model, get_stubbed_vocoder, stub_config
from fastspeech2_lightning_tpu_torch.convert import hifigan_state_from_jax
from fastspeech2_lightning_tpu_torch.models.hifigan import (
    HiFiGANConfig,
    load_vocoder_params,
    make_vocoder_fn,
)
from fastspeech2_lightning_tpu_torch.serving.server import SynthesisServer
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.synthesis.streaming import windowed_vocode

torch.set_num_threads(2)
ATOL = 2e-5  # the JAX package's own streaming tolerance (tests/test_streaming.py)
PCM_STEPS = 2
N_MELS = 20
LONG_TEXT = ("hello world, how are you today. the quick brown fox jumps over the lazy "
             "dog. then it runs away, far from here, and never comes back again.")


@pytest.fixture(scope="module")
def vocoders(tmp_path_factory):
    jvoc, path = get_stubbed_vocoder(tmp_path_factory.mktemp("voc"))
    params, config, _ = load_vocoder_params(path)
    return jvoc, make_vocoder_fn(params, config, device="cpu"), path


def _full(voc, mel):
    wav, _sr = voc(mel[None])
    return np.asarray(wav, dtype=np.float32)[0]


def _mel(T, seed=0):
    return np.random.default_rng(seed).normal(size=(T, N_MELS)).astype(np.float32)


def test_margin_is_the_receptive_field(vocoders):
    jvoc, pvoc, _ = vocoders
    assert pvoc.receptive_margin_frames == jvoc.receptive_margin_frames == 7
    assert HiFiGANConfig().receptive_margin_frames == 15  # V1


CASES = {
    # name: (T, window) with the stub's margin 7, W = window + 14
    "short_mel_bucket": (40, 128),
    "one_frame_above_W": (143, 128),
    "window_64": (300, 64),
    "window_128": (300, 128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_vocode_matches_jax(vocoders, case):
    jvoc, pvoc, _ = vocoders
    T, window = CASES[case]
    mel = _mel(T)
    want = list(j_windowed_vocode(jvoc, mel, window=window))
    got = list(windowed_vocode(pvoc, mel, window=window))
    assert [len(s) for s in got] == [len(s) for s in want]
    assert (len(got) == 1) == (case == "short_mel_bucket")
    for p, j in zip(got, want):
        np.testing.assert_allclose(p, np.asarray(j), rtol=0, atol=ATOL)
    out = np.concatenate(got)
    assert out.shape == (T * pvoc.hop,)
    if case != "short_mel_bucket":
        np.testing.assert_allclose(out, _full(pvoc, mel), rtol=0, atol=ATOL)


def test_short_mel_is_padded_to_a_32_frame_bucket(vocoders):
    _, pvoc, _ = vocoders
    mel = _mel(40, seed=1)
    (seg,) = windowed_vocode(pvoc, mel, window=128)
    padded = np.pad(mel, ((0, 64 - 40), (0, 0)))  # round_up(40, 32) = 64
    np.testing.assert_allclose(seg, _full(pvoc, padded)[: 40 * pvoc.hop], rtol=0, atol=ATOL)


def test_margin_zero_differs_as_in_jax(vocoders):
    jvoc, pvoc, _ = vocoders
    mel = _mel(300, seed=2)
    full = _full(pvoc, mel)
    bad = np.concatenate(list(windowed_vocode(pvoc, mel, window=64, margin=0)))
    jbad = np.concatenate([np.asarray(s) for s in j_windowed_vocode(jvoc, mel, window=64,
                                                                    margin=0)])
    np.testing.assert_allclose(bad, jbad, rtol=0, atol=ATOL)
    assert np.abs(bad - full).max() > 0.05 * np.abs(full).max()


def test_fused_vocoder_streams_what_it_vocodes_whole():
    """A generator whose first stage has C = 32 (a width the MRF kernel
    takes), fused; on the CPU its stage runs the kernel's plain version on
    the prepared weights."""
    kw = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
              upsample_initial_channel=64, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3),), n_mels=N_MELS)
    params = jax.tree_util.tree_map(np.array, init_random_hifigan(JHiFiGANConfig(**kw)))
    cfg = HiFiGANConfig(**kw)
    voc = make_vocoder_fn(hifigan_state_from_jax(params, cfg), cfg, fused=True, device="cpu")
    mel = _mel(200, seed=3)
    out = np.concatenate(list(windowed_vocode(voc, mel, window=64)))
    np.testing.assert_allclose(out, _full(voc, mel), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def synthesizers(vocoders, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model")
    _, orbax_dir = get_stubbed_model(tmp / "model", config=stub_config(dtype="float32"))
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp / "model.ckpt")
    voc_path = vocoders[2]
    return (JSynthesizer.from_checkpoint(orbax_dir, vocoder_path=voc_path),
            Synthesizer.from_checkpoint(ckpt, vocoder_path=voc_path, device="cpu"))


def test_synthesize_stream_equals_per_mel_vocoding(synthesizers):
    _, syn = synthesizers
    segs = list(syn.synthesize_stream(LONG_TEXT, window=64))
    chunks = syn._chunk_text(LONG_TEXT, None)
    assert len(chunks) > 1
    mels = syn.synthesize(chunks, vocode=False).mels
    direct = np.concatenate([_full(syn.vocoder, m) for m in mels])
    streamed = np.concatenate(segs)
    assert streamed.shape == direct.shape
    np.testing.assert_allclose(streamed, direct, rtol=0, atol=ATOL)


def test_synthesize_stream_matches_jax(synthesizers):
    jsyn, syn = synthesizers
    want = np.concatenate([np.asarray(s) for s in jsyn.synthesize_stream(LONG_TEXT, window=64)])
    got = np.concatenate(list(syn.synthesize_stream(LONG_TEXT, window=64)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def server(synthesizers, vocoders):
    """The stub model with the stub vocoder's last conv scaled up, so that
    its audio (about 1e-6 as stubbed) is audible in PCM16."""
    _, syn = synthesizers
    params, config, _ = load_vocoder_params(vocoders[2])
    params = {k: v * 3e4 if k.startswith("conv_post.") else v for k, v in params.items()}
    loud = Synthesizer(syn.model, syn.config, syn.stats, syn.lang2id, syn.speaker2id,
                       vocoder=make_vocoder_fn(params, config, device="cpu"))
    srv = SynthesisServer(loud, port=0, max_batch=4)
    srv.start()
    yield srv
    srv.shutdown()


def _post(server, payload):
    host, port = server.address[:2]
    req = urllib.request.Request(f"http://{host}:{port}/synthesize",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers, r.read()


def _stats(server):
    host, port = server.address[:2]
    with urllib.request.urlopen(f"http://{host}:{port}/stats", timeout=60) as r:
        return json.loads(r.read())


def _pcm(body):
    assert body[:4] == b"RIFF" and body[36:40] == b"data"
    return np.frombuffer(body[44:], dtype="<i2").astype(np.int32)


def test_low_latency_body_equals_the_batched_wav(server):
    """Equal length, and equal within 2 PCM16 steps but for each chunk's
    last `margin` frames: the batched path vocodes a chunk's mel padded with
    the decoder's frames past its end (the batch's 128-frame bucket), which
    those frames' receptive field reaches; the stream ends at the chunk's
    true edge (the JAX package's behaviour in both paths)."""
    before = _stats(server).get("low_latency_requests", 0)
    status, headers, body = _post(server, {"text": LONG_TEXT, "low_latency": True,
                                           "window": 64})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    _, _, batched = _post(server, {"text": LONG_TEXT})
    a, b = _pcm(body), _pcm(batched)
    assert a.shape == b.shape and int(np.abs(b).max()) > 100
    syn = server.synthesizer
    hop, margin = syn.vocoder.hop, syn.vocoder.receptive_margin_frames
    mels = syn.synthesize(syn._chunk_text(LONG_TEXT, None), vocode=False).mels
    start, checked = 0, 0
    for mel in mels:
        end = start + len(mel) * hop
        inner = slice(start, end - margin * hop)
        assert int(np.abs(a[inner] - b[inner]).max()) <= PCM_STEPS
        checked += inner.stop - inner.start
        start = end
    assert start == a.size and checked > 0.5 * a.size
    assert _stats(server)["low_latency_requests"] == before + 1


@pytest.mark.parametrize("window", [0, 1025, "wide"])
def test_low_latency_refuses_a_bad_window(server, window):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, {"text": "abc", "low_latency": True, "window": window})
    assert err.value.code == 400


@pytest.mark.parametrize("asked,used", [(1, 64), (100, 128), (1024, 1024)])
def test_low_latency_rounds_the_window(server, monkeypatch, asked, used):
    syn = server.synthesizer
    seen = {}
    real = syn.synthesize_stream

    def spy(text, **kwargs):
        seen.update(kwargs)
        return real(text, **kwargs)

    monkeypatch.setattr(syn, "synthesize_stream", spy)
    status, _, _ = _post(server, {"text": "abc def", "low_latency": True, "window": asked})
    assert status == 200
    assert seen["window"] == used and seen["style_reference"] is None


def test_low_latency_failures(server, monkeypatch):
    syn = server.synthesizer

    def fails_at_once(text, **kwargs):
        raise ValueError("no symbols")
        yield  # pragma: no cover

    monkeypatch.setattr(syn, "synthesize_stream", fails_at_once)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, {"text": "abc", "low_latency": True})
    assert err.value.code == 400

    def fails_after_one(text, **kwargs):
        yield np.full(256, 0.5, np.float32)
        raise RuntimeError("device lost")

    monkeypatch.setattr(syn, "synthesize_stream", fails_after_one)
    status, _, body = _post(server, {"text": "abc", "low_latency": True})
    assert status == 200
    np.testing.assert_array_equal(_pcm(body), np.full(256, int(0.5 * 32767)))
