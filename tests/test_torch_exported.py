"""The port's serving artifacts (synthesis/exported.py) against the JAX
package's and against the port's live Synthesizer.

A stubbed JAX checkpoint (f32 config) is exported by the JAX package
(``export_serving_artifact``, StableHLO) and, converted to a Lightning
.ckpt, by the port (``torch.export``), both at the JAX test's options:
batch 2, text buckets 16 and 48, 512 frames, the stubbed HiFiGAN. The port's
manifest (B, L, T of every program) equals JAX's; its artifact matches the
port's live Synthesizer (durations equal, mels and wavs within 1e-6, f32)
and JAX's ExportedSynthesizer (durations equal, max-abs 1e-4, the tolerance
of tests/test_torch_synthesize.py); its acoustic graphs reach kernel A only
through the op ``fs2t::attention_fwd``. Then the artifact's surface: serving
with no checkpoint, uncovered shapes, micro-batching, long text, streaming,
``serve model.fs2x`` over HTTP, the refusals, a phonological-feature model,
and the ``export-serving`` command."""

import contextlib
import io
import json
import urllib.error
import urllib.request
import zipfile
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.serving.server import serve as jax_serve
from fastspeech2_lightning_tpu.synthesis.exported import (
    ExportedSynthesizer as JaxExportedSynthesizer,
)
from fastspeech2_lightning_tpu.synthesis.exported import (
    export_serving_artifact as jax_export_serving_artifact,
)
from fastspeech2_lightning_tpu.testing import get_stubbed_model, get_stubbed_vocoder, stub_config
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.models.hifigan import hifigan_generator, load_vocoder_params
from fastspeech2_lightning_tpu_torch.serving.server import serve
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.synthesis.exported import (
    ExportedSynthesizer,
    export_serving_artifact,
    parse_platforms,
)

torch.set_num_threads(2)

TEXTS = ["hello world", "a longer sentence to synthesize today"]
OPTIONS = dict(batch_sizes=(2,), text_buckets=(16, 48), max_frames=512)
CPU = "cpu"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(port artifact, JAX artifact, port .ckpt, vocoder .npz)."""
    tmp = tmp_path_factory.mktemp("exported")
    _, orbax_dir = get_stubbed_model(tmp / "model", config=stub_config(dtype="float32"))
    _, voc = get_stubbed_vocoder(tmp / "voc")
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp / "model.ckpt")
    jax_art = jax_export_serving_artifact(orbax_dir, tmp / "jax.fs2x", vocoder_path=voc,
                                          **OPTIONS)
    port_art = export_serving_artifact(ckpt, tmp / "port.fs2x", vocoder_path=voc, device=CPU,
                                       **OPTIONS)
    return port_art, jax_art, ckpt, voc


@pytest.fixture(scope="module")
def ex(artifacts):
    """The port's artifact loaded once for the tests that only read it."""
    with ExportedSynthesizer(artifacts[0], device=CPU) as synthesizer:
        yield synthesizer


@pytest.fixture(scope="module")
def port_result(ex):
    return ex.synthesize(TEXTS)


def _meta(path) -> dict:
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("meta.json"))


def _shapes(meta) -> dict:
    return {"acoustic": [(e["B"], e["L"], e["T"]) for e in meta["acoustic"]],
            "vocoder": [(e["B"], e["T"]) for e in meta["vocoder"]],
            "vocoder_streaming": [(e["window"], e["W"]) for e in meta["vocoder_streaming"]]}


def test_manifest_and_meta_keys_equal_jax(artifacts):
    port, jax_art = _meta(artifacts[0]), _meta(artifacts[1])
    assert _shapes(port) == _shapes(jax_art)
    assert set(port) - {"torch_version"} == set(jax_art) - {"jax_version"}
    for key in ("format_version", "mel_key", "max_frames", "hop", "vocoder_meta",
                "global_step", "lang2id", "speaker2id"):
        assert port[key] == jax_art[key], key
    assert port["platforms"] == ["cpu"] and jax_art["platforms"] == ["cpu"]


def test_artifact_layout(artifacts):
    names = set(zipfile.ZipFile(artifacts[0]).namelist())
    assert {"meta.json", "params.pt", "vocoder_params.pt"} <= names
    # the largest text bucket also gets the full-cap program
    assert "acoustic/B2_L48_T512.cpu.pt2" in names
    assert {n.split("/")[0] for n in names if n.endswith(".pt2")} == {
        "acoustic", "vocoder", "vocoder_streaming"}
    for e in _meta(artifacts[0])["acoustic"]:
        assert set(e["files"]) == {"cpu"} and e["files"]["cpu"] in names


@pytest.fixture(scope="module")
def live_result(artifacts):
    _, _, ckpt, voc = artifacts
    return Synthesizer.from_checkpoint(ckpt, vocoder_path=voc, device=CPU).synthesize(TEXTS)


@pytest.fixture(scope="module")
def jax_result(artifacts):
    with JaxExportedSynthesizer(artifacts[1]) as ex:
        return ex.synthesize(TEXTS)


@pytest.mark.parametrize("reference,atol", [("live", 1e-6), ("jax", 1e-4)])
def test_artifact_matches_live_path_and_jax_artifact(port_result, live_result, jax_result,
                                                     reference, atol):
    want = live_result if reference == "live" else jax_result
    got = port_result
    assert got.sample_rate == want.sample_rate
    for a, b in zip(got.durations, want.durations):
        np.testing.assert_array_equal(a, b)
    assert sum(int(d.sum()) for d in got.durations) > 0
    for field in ("mels", "wavs"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_acoustic_graphs_reach_attention_only_through_the_op(artifacts):
    cfg = stub_config(dtype="float32").model
    layers = cfg.encoder.layers + cfg.decoder.layers
    with zipfile.ZipFile(artifacts[0]) as zf:
        for e in _meta(artifacts[0])["acoustic"]:
            ep = torch.export.load(io.BytesIO(zf.read(e["files"]["cpu"])))
            ops = Counter(str(n.target) for n in ep.graph.nodes if n.op == "call_function")
            assert ops["fs2t.attention_fwd.default"] == layers, e
            assert not [op for op in ops if "softmax" in op], e
            # the weights are arguments, not constants of the program
            assert not ep.graph_signature.parameters and not ep.constants


def test_exported_needs_no_checkpoint(artifacts, tmp_path):
    moved = tmp_path / "standalone.fs2x"
    moved.write_bytes(Path(artifacts[0]).read_bytes())
    with ExportedSynthesizer(moved, device=CPU) as ex:
        r = ex.synthesize(["hello"], vocode=False)
    assert r.mels[0].ndim == 2 and r.wavs is None


def test_uncovered_shape_raises_and_a_larger_batch_is_micro_batched(ex):
    with pytest.raises(ValueError, match="no exported acoustic program"):
        ex.synthesize(["x" * 100])  # L = 112 > the largest bucket, 48
    r = ex.synthesize(["one", "two", "three"], vocode=False)
    assert len(r.mels) == 3
    # the third row ran alone in the B = 2 program: the same as in a batch
    np.testing.assert_allclose(r.mels[2], ex.synthesize(["three"]).mels[0], atol=1e-6)


def test_long_text_chunks(ex):
    text = "hello there. " * 8  # 104 characters; the chunks fit the 48 bucket
    assert len(ex._chunk_long_text(text)) > 1
    r = ex.synthesize_long(text)
    assert len(r.mels) == 1 and len(r.wavs) == 1
    assert r.mels[0].shape[0] * ex.vocoder.hop == r.wavs[0].shape[0]


def test_stream_equals_vocoding_the_whole_mel(artifacts, ex):
    _, _, _, voc = artifacts
    kwargs = dict(duration_control=40.0)  # a mel longer than one window's slice
    W = 128 + 2 * ex.meta["vocoder_meta"]["margin"]
    mel = ex.synthesize(["hello world"], vocode=False, **kwargs).mels[0]
    assert mel.shape[0] > W
    stream = np.concatenate(list(ex.synthesize_stream("hello world", window=128, **kwargs)))
    with pytest.raises(ValueError, match="was not exported"):
        list(ex.synthesize_stream("hello", window=64))
    params, vcfg, _ = load_vocoder_params(voc)
    p = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    full = hifigan_generator(p, torch.as_tensor(mel)[None], vcfg)[0].numpy()
    assert stream.shape == full.shape
    np.testing.assert_allclose(stream, full, rtol=0, atol=2e-5)


def test_warmup_runs_every_program(ex):
    assert ex.warmup(2) == sum(len(ex.meta[k]) for k in
                               ("acoustic", "vocoder", "vocoder_streaming")) == 5


def _post(base, payload):
    req = urllib.request.Request(f"{base}/synthesize", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=300)


def test_serve_from_artifact(artifacts, port_result):
    srv = serve(str(artifacts[0]), port=0, max_batch=2, device=CPU)
    srv.start()
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["has_vocoder"] is True
        with _post(base, {"text": TEXTS[0], "format": "mel"}) as r:
            np.testing.assert_allclose(np.load(io.BytesIO(r.read())), port_result.mels[0],
                                       atol=1e-6)
        with _post(base, {"text": TEXTS[0]}) as r:
            assert r.read()[:4] == b"RIFF"
        with _post(base, {"text": "hello", "low_latency": True}) as r:
            assert r.read()[:4] == b"RIFF"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, {"text": "hello", "low_latency": True, "window": 64})
        assert err.value.code == 400
    finally:
        srv.shutdown()


REFUSED = {
    "vocoder_path": "stub.npz",
    "use_ema": True,
    "data_parallel": 2,
    "max_frames": 256,
    "style_reference": "ref.wav",
    "vocoder_precision": "bfloat16",
    "vocoder_fused": True,
}


@pytest.mark.parametrize("option", list(REFUSED))
def test_serve_refuses_options_fixed_at_export(artifacts, option):
    with pytest.raises(ValueError, match="fixed at export time") as got:
        serve(str(artifacts[0]), device=CPU, **{option: REFUSED[option]})
    if option != "vocoder_fused":  # the port's own option
        with pytest.raises(ValueError) as want:
            jax_serve(str(artifacts[1]), **{option: REFUSED[option]})
        assert str(got.value) == str(want.value)


def test_a_style_reference_is_refused_and_none_is_taken(ex):
    """The server passes its style reference (None for an artifact) to
    every synthesize and synthesize_stream call."""
    with pytest.raises(ValueError, match="fixed at export time"):
        ex.synthesize(["hello"], style_reference="ref.wav")
    assert len(ex.synthesize(["hello"], vocode=False, style_reference=None).mels) == 1


def _rewritten(src: Path, dst: Path, **meta_changes) -> Path:
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), **meta_changes})
            zout.writestr(name, data)
    return dst


def test_refuses_an_unknown_format_a_jax_artifact_and_a_missing_platform(artifacts, tmp_path):
    port_art, jax_art = artifacts[:2]
    with pytest.raises(ValueError, match="unsupported artifact format '9.9'"):
        ExportedSynthesizer(_rewritten(port_art, tmp_path / "v9.fs2x", format_version="9.9"),
                            device=CPU)
    with pytest.raises(ValueError, match="exported by the JAX package.*StableHLO"):
        ExportedSynthesizer(jax_art, device=CPU)
    with pytest.raises(ValueError, match="exported by the JAX package"):
        serve(str(jax_art), device=CPU)
    with pytest.raises(ValueError, match="holds no programs for 'cpu'"):
        ExportedSynthesizer(_rewritten(port_art, tmp_path / "cuda.fs2x", platforms=["cuda"]),
                            device=CPU)


def test_platform_names_and_a_cuda_export_without_a_card(artifacts, tmp_path):
    assert parse_platforms("gpu") == ["cuda"]
    assert parse_platforms("cpu, cuda") == ["cpu", "cuda"]
    assert parse_platforms(None) is None
    with pytest.raises(ValueError, match="JAX package"):
        parse_platforms("cpu,tpu")
    if torch.cuda.is_available():
        return  # the refusal below is for hosts without a card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving_artifact(artifacts[2], tmp_path / "x.fs2x", platforms="cuda",
                                device=CPU, batch_sizes=(1,), text_buckets=(16,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExportedSynthesizer(artifacts[0])


def _port_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli.main(argv)
        except SystemExit as e:
            return e.code, out.getvalue(), err.getvalue()
    return 0, out.getvalue(), err.getvalue()


def test_cli_export_serving(artifacts, tmp_path):
    _, _, ckpt, voc = artifacts
    out = tmp_path / "cli.fs2x"
    code, stdout, err = _port_cli(["export-serving", str(ckpt), "-o", str(out), "-v", str(voc),
                                   "-b", "1", "--text-bucket", "16", "--max-frames", "256",
                                   "--device", "cpu"])
    assert code == 0, err
    assert stdout.strip() == (f"exported serving artifact -> {out} "
                              f"({out.stat().st_size / 1e6:.1f} MB)")
    assert _shapes(_meta(out)) == {"acoustic": [(1, 16, 256)], "vocoder": [(1, 256)],
                                   "vocoder_streaming": [(128, 142)]}
    code, _, err = _port_cli(["export-serving", str(ckpt), "-o", str(out), "--platforms",
                              "tpu", "--device", "cpu"])
    assert code == 2 and "JAX package" in err


def test_a_pfs_model_through_the_artifact_equals_the_live_path(tmp_path):
    config = stub_config(dtype="float32", target_text_representation_level="phonological_features")
    _, orbax_dir = get_stubbed_model(tmp_path / "model", config=config)
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp_path / "pfs.ckpt")
    art = export_serving_artifact(ckpt, tmp_path / "pfs.fs2x", batch_sizes=(2,),
                                  text_buckets=(48,), max_frames=512, device=CPU)
    texts = ["hello world", "the quick brown fox"]
    with ExportedSynthesizer(art, device=CPU) as ex:
        assert ex.is_pfs
        got = ex.synthesize(texts)
    want = Synthesizer.from_checkpoint(ckpt, device=CPU).synthesize(texts)
    for a, b in zip(got.durations, want.durations):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.mels, want.mels):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
