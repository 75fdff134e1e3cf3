"""Data-parallel serving, bulk synthesis and the window-parallel vocoder of
the PyTorch port (``parallel/replicas.py``, ``Synthesizer(data_parallel=)``,
``synthesize_items(devices=)``, ``make_parallel_vocoder_fn``,
``serve(data_parallel=)``) on CPU replicas, against the JAX package on the
8 virtual CPU devices ``tests/conftest.py`` sets up, at the stub sizes.

Each test is the counterpart of a JAX test and holds the port to its
tolerance: ``test_parallel.py::test_data_parallel_synthesizer_matches_single_device``
(B 3 over 4 replicas: mels within 2e-5, durations equal, against one
replica and against JAX's 4-device mesh) and
``::test_synthesize_items_data_parallel_matches_single`` (a partial batch
over 2); ``test_streaming.py::test_parallel_vocoder_matches_single_device``
at (1, 300), (2, 257) and (1, 2048) over 8 replicas (and fused, where the
MRF stage's plain version runs), ``..._short_mel_plain_path`` and
``..._mesh_synthesizer_engages_window_parallel_vocoder``;
``test_serving.py::test_serve_data_parallel_mesh``. Beside them: a
data-parallel Synthesizer streams what one replica streams, warms up every
replica at the batch rounded up, and more cards than there are is a
ValueError naming both numbers."""

import io
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from fastspeech2_lightning_tpu.models.hifigan import hifigan_generator as j_generator
from fastspeech2_lightning_tpu.models.hifigan import init_random_hifigan
from fastspeech2_lightning_tpu.models.hifigan import make_parallel_vocoder_fn as j_parallel
from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.parallel.mesh import make_mesh
from fastspeech2_lightning_tpu.synthesis.api import Synthesizer as JSynthesizer
from fastspeech2_lightning_tpu.synthesis.prepare import prepare_data as j_prepare_data
from fastspeech2_lightning_tpu.synthesis.synthesize import load_model_from_checkpoint as j_load
from fastspeech2_lightning_tpu.synthesis.synthesize import synthesize_items as j_synthesize_items
from fastspeech2_lightning_tpu.synthesis.writers import get_synthesis_output_writers as j_writers
from fastspeech2_lightning_tpu.testing import get_stubbed_model, get_stubbed_vocoder, stub_config
from fastspeech2_lightning_tpu.type_definitions import SynthesizeOutputFormats as JFormats
from fastspeech2_lightning_tpu_torch.checkpoint import load_model_from_checkpoint
from fastspeech2_lightning_tpu_torch.convert import hifigan_state_from_jax
from fastspeech2_lightning_tpu_torch.models.hifigan import (
    HiFiGANConfig,
    hifigan_generator,
    make_parallel_vocoder_fn,
)
from fastspeech2_lightning_tpu_torch.parallel import replicas
from fastspeech2_lightning_tpu_torch.serving.server import serve
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.synthesis.prepare import prepare_data
from fastspeech2_lightning_tpu_torch.synthesis.synthesize import synthesize_items
from fastspeech2_lightning_tpu_torch.synthesis.writers import get_synthesis_output_writers
from fastspeech2_lightning_tpu_torch.type_definitions import SynthesizeOutputFormats

torch.set_num_threads(2)
ATOL = 2e-5  # the JAX package's data-parallel tolerance
CPU = torch.device("cpu")
TEXTS = ["abc", "a b c d e", "zz"]  # B 3: padded to 4 rows over 4 replicas
LONG_TEXT = ("hello world, how are you today. the quick brown fox jumps over the lazy "
             "dog. then it runs away, far from here, and never comes back again.")


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    _, orbax_dir = get_stubbed_model(tmp / "model", config=stub_config(dtype="float32"))
    _, voc = get_stubbed_vocoder(tmp / "voc")
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp / "model.ckpt")
    return tmp, orbax_dir, ckpt, voc


@pytest.fixture(scope="module")
def port_synths(stub):
    """One replica and four, without a vocoder."""
    _, _, ckpt, _ = stub
    return (Synthesizer.from_checkpoint(ckpt, max_frames=128, device="cpu"),
            Synthesizer.from_checkpoint(ckpt, max_frames=128, device="cpu", data_parallel=4))


def test_data_parallel_synthesizer_matches_single_device(stub, port_synths):
    _, orbax_dir, _, _ = stub
    single, dp = port_synths
    assert dp.devices == [CPU] * 4 and len(dp.replicas) == 4
    assert len({id(m) for m in dp._models}) == 4 and dp._models[0] is dp.model
    jdp = JSynthesizer.from_checkpoint(orbax_dir, max_frames=128, data_parallel=4)
    assert jdp.mesh.shape["data"] == 4
    a = single.synthesize(TEXTS, adaptive_max_frames=False)
    b = dp.synthesize(TEXTS, adaptive_max_frames=False)
    c = jdp.synthesize(TEXTS, adaptive_max_frames=False)
    assert len(b.mels) == len(b.durations) == 3
    for want in (a, c):
        for i in range(3):
            assert b.mels[i].shape == want.mels[i].shape
            np.testing.assert_allclose(b.mels[i], want.mels[i], rtol=0, atol=ATOL)
            np.testing.assert_array_equal(b.durations[i], want.durations[i])
    assert sum(m.shape[0] for m in b.mels) > 0


def test_data_parallel_adaptive_bucket_and_warmup(port_synths):
    """The adaptive frame bucket over every replica (a re-run runs them
    all), and warmup on every replica at the batch rounded up to 4 rows."""
    single, dp = port_synths
    texts = TEXTS + ["hello there, general kenobi"]
    a, b = single.synthesize(texts), dp.synthesize(texts)
    for x, y, dx, dy in zip(a.mels, b.mels, a.durations, b.durations):
        np.testing.assert_allclose(y, x, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(dy, dx)
    rows = []
    forward = dp._forward

    def counted(text, *args, **kwargs):
        rows.append((kwargs["replica"], text.shape[0]))
        return forward(text, *args, **kwargs)

    dp._forward = counted
    try:
        assert dp.warmup(3) == 1
    finally:
        del dp._forward
    assert sorted(rows) == [(i, 1) for i in range(4)]


def test_synthesize_items_data_parallel_matches_single(stub):
    """A partial batch (3 items at batch 4 over 2 replicas): the spec files
    of one replica and of JAX's 2-device mesh."""
    tmp, orbax_dir, ckpt, _ = stub
    texts = ["abc", "de fgh", "ij"]
    jmodel, variables, jconfig, jstats, jl, js, jstep = j_load(orbax_dir)
    jconfig.model.max_mel_length = 128
    items = j_prepare_data(texts=texts, language=None, speaker=None, filelist=None,
                           config=jconfig, stats=jstats, lang2id=jl, speaker2id=js)
    j_synthesize_items(items, jmodel, variables, jconfig, jl, js,
                       j_writers([JFormats.spec], tmp / "jax", jconfig, "output", jstep),
                       batch_size=4, mesh=make_mesh(n_devices=2, model_parallel=1))
    model, config, stats, lang2id, speaker2id, step = load_model_from_checkpoint(ckpt,
                                                                                 device="cpu")
    config.model.max_mel_length = 128

    def run(out, devices):
        items = prepare_data(texts=texts, language=None, speaker=None, filelist=None,
                             config=config, stats=stats, lang2id=lang2id,
                             speaker2id=speaker2id)
        writers = get_synthesis_output_writers([SynthesizeOutputFormats.spec], tmp / out,
                                               config, "output", step)
        synthesize_items(items, model, config, lang2id, speaker2id, writers, batch_size=4,
                         devices=devices)
        return sorted((tmp / out).glob("**/*.npy"))

    single, dp = run("single", None), run("dp", ["cpu", "cpu"])
    jax_files = sorted((tmp / "jax").glob("**/*.npy"))
    assert [p.name for p in dp] == [p.name for p in single] == [p.name for p in jax_files]
    assert len(dp) == 3
    for got, one, want in zip(dp, single, jax_files):
        np.testing.assert_allclose(np.load(got), np.load(one), rtol=0, atol=ATOL)
        np.testing.assert_allclose(np.load(got), np.load(want), rtol=0, atol=ATOL)


def _tiny_gen(channels: int = 32):
    config = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                  upsample_initial_channel=channels, resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3),), n_mels=20)
    jconfig = JHiFiGANConfig(**config)
    params = init_random_hifigan(jconfig)
    pconfig = HiFiGANConfig(**config)
    return params, jconfig, hifigan_state_from_jax(params, pconfig), pconfig


@pytest.fixture(scope="module")
def gens():
    return {c: _tiny_gen(c) for c in (32, 64)}


def _plain(sd, config, mel):
    p = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    return hifigan_generator(p, torch.as_tensor(mel), config).numpy()


@pytest.mark.parametrize("shape", [(1, 300), (2, 257), (1, 2048)])
def test_parallel_vocoder_matches_single_device(gens, shape):
    """Window-parallel over 8 replicas: the plain generator and JAX's
    window-parallel vocoder on its 8-device mesh."""
    jparams, jconfig, sd, config = gens[32]
    voc = make_parallel_vocoder_fn(sd, config, ["cpu"] * 8)
    B, T = shape
    mel = np.random.default_rng(T).normal(size=(B, T, 20)).astype(np.float32)
    wav, sr = voc(mel)
    assert sr == config.sampling_rate and voc.device == CPU
    plan = voc._window_cache[(B, T)]
    assert plan is not None and len(plan[2]) == 8  # split into 8 windows
    full = _plain(sd, config, mel)
    assert wav.shape == full.shape == (B, T * config.total_upsampling)
    np.testing.assert_allclose(wav, full, rtol=0, atol=ATOL)
    jwav, _ = j_parallel(jparams, jconfig, make_mesh())(mel)
    np.testing.assert_allclose(wav, np.asarray(jwav), rtol=0, atol=ATOL)


def test_parallel_vocoder_fused_and_row_parallel(gens):
    """With the MRF stage fused (its plain version on the CPU): in windows
    for one row, row-parallel (nothing crosses replicas) for a block a
    replica; both the plain unfused generator."""
    _, _, sd, config = gens[64]
    voc = make_parallel_vocoder_fn(sd, config, ["cpu"] * 2, fused=True)
    rng = np.random.default_rng(5)
    mel = rng.normal(size=(1, 300, 20)).astype(np.float32)
    np.testing.assert_allclose(voc(mel)[0], _plain(sd, config, mel), rtol=0, atol=ATOL)
    mel4 = rng.normal(size=(4, 64, 20)).astype(np.float32)
    blocks = [torch.as_tensor(mel4[:2]), torch.as_tensor(mel4[2:])]
    wav = voc.device_fn(blocks, n_real=3).numpy()
    assert wav.shape[0] == 3 and (3, 64) not in voc._window_cache
    np.testing.assert_allclose(wav, _plain(sd, config, mel4)[:3], rtol=0, atol=ATOL)


@pytest.mark.parametrize("T", [24, 12])
def test_parallel_vocoder_short_mel_plain_path(gens, T):
    """JAX's case, T 24 (with this generator's margin of 7 it still splits
    into 8 windows of 3 frames), and T 12, within one window's 2 + 2 * 7
    frames: one plain call."""
    jparams, jconfig, sd, config = gens[32]
    voc = make_parallel_vocoder_fn(sd, config, ["cpu"] * 8)
    mel = np.random.default_rng(3).normal(size=(1, T, 20)).astype(np.float32)
    wav, _ = voc(mel)
    assert (voc._window_cache[(1, T)] is None) == (T == 12)
    np.testing.assert_allclose(wav, _plain(sd, config, mel), rtol=0, atol=ATOL)
    full = np.asarray(j_generator(jparams, jnp.asarray(mel), jconfig))
    np.testing.assert_allclose(wav, full, rtol=0, atol=ATOL)


def test_data_parallel_synthesizer_engages_window_parallel_vocoder(stub):
    """A long request alone through 8 replicas: the row-0 fill must not pass
    for a full batch, so the vocoder splits the frame axis; the wav is one
    replica's."""
    _, _, ckpt, voc = stub
    text = ["window parallel engagement check"]
    kwargs = dict(duration_control=30.0, vocode=True)  # a long mel
    dp = Synthesizer.from_checkpoint(ckpt, vocoder_path=voc, data_parallel=8, max_frames=512,
                                     device="cpu")
    got = dp.synthesize(text, **kwargs)
    plans = {k: v for k, v in dp.vocoder._window_cache.items() if k[0] == 1}
    assert plans and all(v is not None for v in plans.values()), dp.vocoder._window_cache
    want = Synthesizer.from_checkpoint(ckpt, vocoder_path=voc, max_frames=512,
                                       device="cpu").synthesize(text, **kwargs)
    assert got.wavs[0].shape == want.wavs[0].shape and got.wavs[0].size > 0
    np.testing.assert_allclose(got.wavs[0], want.wavs[0], rtol=0, atol=ATOL)


def test_synthesize_stream_on_two_replicas_equals_one(stub):
    _, _, ckpt, voc = stub
    one, two = (Synthesizer.from_checkpoint(ckpt, vocoder_path=voc, device="cpu",
                                            data_parallel=n) for n in (None, 2))
    want = list(one.synthesize_stream(LONG_TEXT, window=64))
    got = list(two.synthesize_stream(LONG_TEXT, window=64))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_serve_data_parallel(stub, port_synths):
    _, _, ckpt, _ = stub
    srv = serve(ckpt, port=0, max_batch=4, data_parallel=2, max_frames=128, device="cpu")
    try:
        srv.start()
        assert srv.synthesizer.devices == [CPU, CPU]
        body = json.dumps({"text": "hello world", "format": "mel"}).encode()
        req = urllib.request.Request(f"http://{srv.address[0]}:{srv.address[1]}/synthesize",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            mel = np.load(io.BytesIO(resp.read()))
    finally:
        srv.shutdown()
    want = port_synths[0].synthesize(["hello world"]).mels[0]
    assert mel.ndim == 2 and mel.shape[0] > 0 and mel.shape == want.shape
    np.testing.assert_allclose(mel, want, rtol=0, atol=ATOL)


def test_replica_devices(monkeypatch):
    assert replicas.replica_devices(data_parallel=3, device="cpu") == [CPU] * 3
    assert replicas.replica_devices(["cpu", "cpu"]) == [CPU, CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert replicas.replica_devices(data_parallel=2) == [torch.device("cuda", i)
                                                         for i in range(2)]
    assert replicas.replica_devices(["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError,
                       match=r"need 3 CUDA devices \(.*\), but torch.cuda.device_count\(\) is 2"):
        replicas.replica_devices(data_parallel=3)
    with pytest.raises(ValueError, match=r"device_count\(\) is 2"):
        replicas.replica_devices(["cuda:0", "cuda:2"])
