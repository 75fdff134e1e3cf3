"""The serving slice as a whole: text -> mel -> wav, and over HTTP.

A stubbed JAX checkpoint (f32 config) is exported with ``fs2t
export-checkpoint``'s function to a Lightning .ckpt, which the port's
Synthesizer loads on the CPU; the JAX Synthesizer loads the orbax
directory. Both get the same stubbed HiFiGAN .npz. Durations must be
equal, mels and wavs within max-abs 1e-4. Then the port's server answers
/health, /stats and /synthesize (mel equal to the Synthesizer's output,
wav a valid RIFF/PCM16 stream)."""

import io
import json
import struct
import urllib.request

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.synthesis.api import Synthesizer as JaxSynthesizer
from fastspeech2_lightning_tpu.testing import get_stubbed_model, get_stubbed_vocoder, stub_config
from fastspeech2_lightning_tpu_torch.serving.server import SynthesisServer
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

torch.set_num_threads(2)

TEXTS = ["hello world, how are you today", "the quick brown fox", "abc"]


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    _, orbax_dir = get_stubbed_model(tmp / "model", config=stub_config(dtype="float32"))
    _, voc_path = get_stubbed_vocoder(tmp / "voc")
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp / "model.ckpt")
    jax_syn = JaxSynthesizer.from_checkpoint(orbax_dir, vocoder_path=voc_path)
    port_syn = Synthesizer.from_checkpoint(ckpt, vocoder_path=voc_path, device="cpu")
    return jax_syn, port_syn


@pytest.fixture(scope="module")
def results(slice_pair):
    jax_syn, port_syn = slice_pair
    return jax_syn.synthesize(TEXTS), port_syn.synthesize(TEXTS)


def test_durations_equal(results):
    want, got = results
    for j, p in zip(want.durations, got.durations):
        np.testing.assert_array_equal(p, j)
    assert sum(int(d.sum()) for d in want.durations) > 0


@pytest.mark.parametrize("field", ["mels", "wavs"])
def test_mels_and_wavs_within_1e_4(results, field):
    want, got = results
    assert got.sample_rate == want.sample_rate
    for j, p in zip(getattr(want, field), getattr(got, field)):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-4)


def test_synthesize_long_reassembles_chunks(slice_pair):
    _, port_syn = slice_pair
    text = "hello world. " * 12
    long = port_syn.synthesize_long(text)
    chunks = port_syn._chunk_text(text, None)
    assert len(chunks) > 1
    parts = port_syn.synthesize(chunks)
    np.testing.assert_allclose(long.mels[0], np.concatenate(parts.mels), rtol=0, atol=1e-5)
    assert long.wavs[0].shape == (long.mels[0].shape[0] * 256,)


@pytest.fixture(scope="module")
def server(slice_pair):
    _, port_syn = slice_pair
    srv = SynthesisServer(port_syn, port=0, max_batch=4, global_step=0)
    srv.start()
    yield srv
    srv.shutdown()


def _get(server, path):
    host, port = server.address[:2]
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=120) as r:
        return r.status, r.headers, r.read()


def _post(server, payload):
    host, port = server.address[:2]
    req = urllib.request.Request(
        f"http://{host}:{port}/synthesize", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers, r.read()


def test_server_health(server):
    status, _, body = _get(server, "/health")
    assert status == 200
    assert json.loads(body) == {"status": "ok", "global_step": 0, "sample_rate": 22050,
                                "has_vocoder": True}


def test_server_mel_equals_synthesizer(server, slice_pair):
    _, port_syn = slice_pair
    status, headers, body = _post(server, {"text": TEXTS[0], "format": "mel"})
    assert status == 200 and headers["X-Chunks"] == "1"
    mel = np.load(io.BytesIO(body))
    want = port_syn.synthesize([TEXTS[0]]).mels[0]
    assert mel.shape == want.shape
    np.testing.assert_allclose(mel, want, rtol=0, atol=1e-4)


def test_server_wav_is_riff_pcm16(server, slice_pair):
    _, port_syn = slice_pair
    status, headers, body = _post(server, {"text": TEXTS[1]})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert body[:4] == b"RIFF" and body[8:16] == b"WAVEfmt "
    fmt, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[20:36])
    assert (fmt, channels, rate, bits) == (1, 1, 22050, 16)
    assert body[36:40] == b"data"
    frames = port_syn.synthesize([TEXTS[1]]).mels[0].shape[0]
    assert (len(body) - 44) // 2 == frames * 256
    _, _, stats = _get(server, "/stats")
    assert json.loads(stats)["batches_dispatched"] >= 1


def test_server_refuses_low_latency(server):
    """Low-latency streaming is served (tests/test_torch_streaming.py); a
    window outside [1, 1024] frames is refused with 400."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, {"text": "abc", "low_latency": True, "window": 0})
    assert err.value.code == 400
    assert "window" in json.loads(err.value.read())["error"]
