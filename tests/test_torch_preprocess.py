"""The port's corpus preprocessing against the JAX package's, on the CPU.

The pieces on the same seeded inputs: the beta-binomial prior (1e-6), the
YIN pitch on tones, noise, silence and formant speech (1e-5 relative, the
same voicing) and against the JAX package's C++ YIN (``test_native``'s
tolerances: median within 2 %, voicing agreeing on 90 % of the frames), the
statistics and their normalization (1e-6), the frame energy (1e-6), the
device pass's fused log-mel and energy on the CPU against
``batched_mel_energy_jax`` (1e-4 on the log-mel 100x above the floor, where
two float32 FFTs agree; 1e-4 relative on the energy) and each sox effect.

Then whole corpora through ``Preprocessor.run``: the six-wav corpus of
``tests/test_preprocessing.py`` with a stereo 44.1 kHz source under sox
effects and two utterances the length filter drops, preprocessed by both
packages (the JAX package with its NumPy pitch golden: ``native.available``
patched to False, as its C++ YIN agrees with the golden only broadly).
Filelists and wavs byte-equal, ``stats.json`` within 1e-6, every spec,
energy and pitch within 1e-5 and the text, attention-prior and pfs arrays
equal; the same for a phone-level config with g2p; ``cpus=2`` byte-equal to
``cpus=1``. The on-device pass (``device="cpu"``) against the JAX package's
on-device pass: both are float32 FFTs from different libraries, so the
log-mel is held to 1e-4 100x above the floor and to the JAX package's own
host-against-device tolerance (2e-2) everywhere, the normalized energy to
1e-4 and ``stats.json`` to 1e-5 relative; and against the host pass with
the JAX test's tolerances (2e-2 and 1e-1). Each package's loader reads the
other's tree into equal batches. The ``-c`` override reader against JAX's
``apply_overrides``, ``convert-artifacts`` against the JAX command, and the
CLIs' usage errors and exit codes against the JAX CLI's."""

import contextlib
import copy
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from scipy.io import wavfile

import fastspeech2_lightning_tpu.native as jnative
from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu.config import FastSpeech2Config as JConfig
from fastspeech2_lightning_tpu.config import apply_overrides as j_apply_overrides
from fastspeech2_lightning_tpu.config import load_config_base_command as j_load_config
from fastspeech2_lightning_tpu.dataset import BucketedLoader as JBucketedLoader
from fastspeech2_lightning_tpu.dataset import FastSpeechDataset as JFastSpeechDataset
from fastspeech2_lightning_tpu.preprocessing import Preprocessor as JPreprocessor
from fastspeech2_lightning_tpu.preprocessing import f0 as jf0
from fastspeech2_lightning_tpu.preprocessing import features as jfeatures
from fastspeech2_lightning_tpu.preprocessing import pipeline as jpipeline
from fastspeech2_lightning_tpu.preprocessing import priors as jpriors
from fastspeech2_lightning_tpu.preprocessing import stats as jstats
from fastspeech2_lightning_tpu.utils import write_filelist as j_write_filelist
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch import config as config_module
from fastspeech2_lightning_tpu_torch.config import (
    FastSpeech2Config,
    apply_overrides,
    load_config_base_command,
)
from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, FastSpeechDataset
from fastspeech2_lightning_tpu_torch.preprocessing import f0, features, pipeline, priors, stats
from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import Preprocessor
from fastspeech2_lightning_tpu_torch.utils import load_filelist, write_filelist

torch.set_num_threads(2)
SR = 22050
TOOLS = Path(__file__).resolve().parents[1] / "tools"
ARTIFACT_ATOL = 1e-5
STATS_RTOL = 1e-6
EFFECTS = [["channels", "1"], ["rate", "22050"], ["norm", "-3"]]


def tone(freq, seconds, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


# -- pieces ------------------------------------------------------------------


@pytest.mark.parametrize("T,L", [(1, 1), (7, 1), (40, 1), (33, 9), (120, 37), (5, 12)])
def test_beta_binomial_prior(T, L):
    got, want = priors.beta_binomial_prior(T, L), jpriors.beta_binomial_prior(T, L)
    assert got.shape == want.shape == (T, L) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _signals():
    rng = np.random.default_rng(3)
    sys.path.insert(0, str(TOOLS))
    from make_corpus import synthesize

    speech, _ = synthesize("quiet flint stone", seed=1, return_tracks=True)
    return {
        "tones": np.concatenate([tone(110, 0.3), tone(220, 0.3), tone(440, 0.3)]),
        "noise": (0.3 * rng.standard_normal(SR // 2)).astype(np.float32),
        "silence": np.zeros(SR // 3, np.float32),
        "speech": speech.astype(np.float32),
    }


@pytest.mark.parametrize("kind", ["tones", "noise", "silence", "speech"])
def test_estimate_f0(kind):
    audio = _signals()[kind]
    got, want = f0.estimate_f0(audio, SR, 256), jf0.estimate_f0(audio, SR, 256)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.skipif(not jnative.available(), reason="the JAX package's C++ YIN did not build")
@pytest.mark.parametrize("freq", [110.0, 220.0, 330.0])
def test_estimate_f0_against_the_native_yin(freq):
    """The port follows the NumPy golden; the JAX package's C++ YIN, which
    its pipeline runs where g++ builds it, agrees with it only broadly."""
    audio = tone(freq, 0.4)
    ours, native = f0.estimate_f0(audio, SR, 256), jnative.yin_f0_native(audio, SR, 256)
    assert ours.shape == native.shape
    assert abs(np.median(native[native > 0]) - freq) / freq < 0.02
    assert abs(np.median(ours[ours > 0]) - freq) / freq < 0.02
    assert np.mean((ours > 0) == (native > 0)) > 0.9


def test_stats_accumulator_and_normalize():
    rng = np.random.default_rng(4)
    chunks = [np.where(rng.random(n) < 0.3, 0.0, rng.normal(150, 40, n)).astype(np.float32)
              for n in (50, 1, 300, 7)]
    acc, jacc = stats.StatsAccumulator(), jstats.StatsAccumulator()
    for c in chunks:
        acc.update(c)
        jacc.update(c)
    got, want = acc.finalize(), jacc.finalize()
    for key, value in want.model_dump().items():
        assert getattr(got, key) == pytest.approx(value, rel=1e-6, abs=1e-6), key
    for c in chunks:
        np.testing.assert_allclose(acc.normalize(c), jacc.normalize(c), rtol=0, atol=1e-6)
    empty = stats.StatsAccumulator().finalize()
    assert empty == stats.StatsAccumulator().finalize() and empty.std == 1.0


def test_stats_json_layout_and_round_trip(tmp_path):
    from fastspeech2_lightning_tpu.type_definitions import Stats as JStats
    from fastspeech2_lightning_tpu_torch.type_definitions import Stats

    acc = stats.StatsAccumulator()
    acc.update(np.array([1.0, 2.0, 4.0]))
    info = acc.finalize()
    s = Stats(pitch=info, energy=info, character_length=info)
    stats.save_stats(s, tmp_path / "p.json")
    jstats.save_stats(JStats(**json.loads((tmp_path / "p.json").read_text())),
                      tmp_path / "j.json")
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert stats.load_stats(tmp_path / "j.json") == s


def test_frame_energy_numpy():
    audio = _signals()["speech"]
    got = features.frame_energy_numpy(audio, 1024, 256, 1024)
    want = jfeatures.frame_energy_numpy(audio, 1024, 256, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("htk", [False, True])
def test_batched_mel_energy_torch_against_jax(htk):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    batch = np.stack([np.pad(tone(180 + 60 * i, 0.5), (0, 4096))
                      + 0.05 * rng.standard_normal(int(0.5 * SR) + 4096).astype(np.float32)
                      for i in range(3)]).astype(np.float32)
    batch[2, 6000:] = 0.0  # a silent tail: the log-mel at its floor
    args = (SR, 1024, 256, 1024, 80, 0, 8000, htk)
    mel, energy = features.batched_mel_energy_torch(torch.from_numpy(batch), *args)
    jmel, jenergy = jfeatures.batched_mel_energy_jax(jnp.asarray(batch), *args)
    jmel, jenergy = np.asarray(jmel), np.asarray(jenergy)
    assert mel.shape == jmel.shape and energy.shape == jenergy.shape
    above = jmel > np.log(100 * features.LOG_CLIP)
    assert above.mean() > 0.5 and (~above).any()
    np.testing.assert_allclose(mel.numpy()[above], jmel[above], rtol=0, atol=1e-4)
    np.testing.assert_allclose(energy.numpy(), jenergy, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("effects,stereo", [
    ([["channels", "1"]], True), ([["rate", "11025"]], False), ([["rate", "44100"]], False),
    ([["norm", "-3"]], False), ([["norm"]], False), ([["gain", "-6"]], False),
    ([["trim", "0.01"]], False), ([["trim", "0.01", "0.02"]], False),
    ([["reverb", "50"]], False), ([["channels", "1"], ["rate", "16000"], ["gain", "3"]], True),
])
def test_sox_effects(effects, stereo):
    rng = np.random.default_rng(6)
    audio = rng.standard_normal((1000, 2) if stereo else 1000).astype(np.float32)
    got, sr = pipeline.apply_sox_effects(audio, 22050, effects)
    want, jsr = jpipeline.apply_sox_effects(audio, 22050, effects)
    assert sr == jsr and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- whole corpora -------------------------------------------------------------


def _write_corpus(root: Path) -> dict:
    """The six-wav corpus, a too-short and a too-long one, and two stereo
    44.1 kHz files under sox effects; the config dict of both packages."""
    rng = np.random.default_rng(0)
    rows = []
    lengths = [0.6 + 0.15 * i for i in range(6)] + [0.4, 0.3, 1.5]
    for i, seconds in enumerate(lengths):
        audio = tone(150 + 40 * i, seconds) + 0.01 * rng.standard_normal(
            int(seconds * SR)).astype(np.float32)
        jpipeline.save_wav(root / "wavs" / f"utt{i}.wav", audio, SR)
        rows.append({"basename": f"utt{i}", "characters": f"hello world number {i}",
                     "language": "default", "speaker": "default"})
    j_write_filelist(rows, root / "filelist.psv")
    (root / "stereo").mkdir()
    srows = []
    for i in range(2):
        t = np.arange(int((0.7 + 0.2 * i) * 44100)) / 44100
        st = np.stack([0.3 * np.sin(2 * np.pi * 200 * t), 0.2 * np.sin(2 * np.pi * 310 * t)], 1)
        wavfile.write(root / "stereo" / f"s{i}.wav", 44100, (st * 32767).astype(np.int16))
        srows.append({"basename": f"s{i}", "characters": f"stereo take {i}"})
    j_write_filelist(srows, root / "stereo.psv")
    return {
        "preprocessing": {
            "train_split": 0.7, "dataset_split_seed": 11,
            "audio": {"max_audio_length": 1.4},
            "source_data": [
                {"data_dir": str(root / "wavs"), "filelist": str(root / "filelist.psv")},
                {"label": "stereo", "data_dir": str(root / "stereo"),
                 "filelist": str(root / "stereo.psv"), "sox_effects": EFFECTS}]},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz0123456789")}},
    }


def _with(cfg: dict, save_dir: Path, **model) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["preprocessing"]["save_dir"] = str(save_dir)
    if model:
        cfg["model"] = model
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    cfg = _write_corpus(root)
    phones = {"target_text_representation_level": "phones"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)  # the NumPy pitch golden
        JPreprocessor(JConfig.model_validate(_with(cfg, root / "jax"))).run(cpus=1)
        JPreprocessor(JConfig.model_validate(_with(cfg, root / "jax_dev"))).run(
            cpus=1, on_device_spec=True)
        JPreprocessor(JConfig.model_validate(_with(cfg, root / "jax_phones", **phones))).run(
            cpus=1)
    results = {
        "port": Preprocessor(FastSpeech2Config.from_dict(_with(cfg, root / "port"))).run(cpus=1),
        "port_dev": Preprocessor(FastSpeech2Config.from_dict(_with(cfg, root / "port_dev"))).run(
            cpus=1, on_device_spec=True, device="cpu"),
    }
    Preprocessor(FastSpeech2Config.from_dict(_with(cfg, root / "port_phones", **phones))).run(
        cpus=1)
    Preprocessor(FastSpeech2Config.from_dict(_with(cfg, root / "port_cpus2"))).run(cpus=2)
    return root, cfg, results


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_trees(got_root: Path, want_root: Path, spec_atol: float = ARTIFACT_ATOL,
                  spectral_rtol_stats: float = STATS_RTOL, spec_floor_atol=None,
                  energy_atol: float = ARTIFACT_ATOL):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want)
    kinds = set()
    for name, path in want.items():
        kinds.add(name.split("/")[0])
        if name.endswith(".npy"):
            a, b = np.load(got[name]), np.load(path)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if name.startswith(("text/", "attn/", "pfs/")):
                np.testing.assert_array_equal(a, b, err_msg=name)
            elif name.startswith("spec/") and spec_floor_atol is not None:
                above = b > np.log(100 * features.LOG_CLIP)
                np.testing.assert_allclose(a[above], b[above], rtol=0, atol=spec_atol,
                                           err_msg=name)
                np.testing.assert_allclose(a, b, rtol=0, atol=spec_floor_atol, err_msg=name)
            else:
                atol = {"spec": spec_atol, "energy": energy_atol}.get(name.split("/")[0],
                                                                     ARTIFACT_ATOL)
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
        elif name == "stats.json":
            a, b = json.loads(got[name].read_text()), json.loads(path.read_text())
            assert a.keys() == b.keys()
            for key in b:
                if b[key] is None:
                    assert a[key] is None
                    continue
                for field, value in b[key].items():
                    assert a[key][field] == pytest.approx(value, rel=spectral_rtol_stats,
                                                          abs=1e-12), (key, field)
        else:  # the filelists and the wavs
            assert got[name].read_bytes() == path.read_bytes(), name
    return kinds


def test_preprocessed_tree_equals_the_jax_tree(trees):
    root, _, results = trees
    kinds = _assert_trees(root / "port", root / "jax")
    assert kinds == {"audio", "spec", "attn", "text", "pfs", "pitch", "energy",
                     "stats.json", "training_filelist.psv", "validation_filelist.psv"}
    rows = load_filelist(root / "port" / "training_filelist.psv") + load_filelist(
        root / "port" / "validation_filelist.psv")
    # the two too-short and too-long utterances are filtered, the stereo ones kept
    assert sorted(r["basename"] for r in rows) == sorted(
        [f"utt{i}" for i in range(7)] + ["s0", "s1"])
    assert (results["port"]["n_train"], results["port"]["n_val"]) == (6, 3)


def test_phone_level_tree_equals_the_jax_tree(trees):
    root = trees[0]
    _assert_trees(root / "port_phones", root / "jax_phones")
    assert list((root / "port_phones" / "attn").glob("*phones-attn-prior.npy"))
    row = load_filelist(root / "port_phones" / "training_filelist.psv")[0]
    assert row["phone_tokens"]


def test_worker_pool_equals_one_process(trees):
    root = trees[0]
    got, want = _tree(root / "port_cpus2"), _tree(root / "port")
    assert sorted(got) == sorted(want)
    for name, path in want.items():
        assert got[name].read_bytes() == path.read_bytes(), name


def test_device_pass_equals_the_jax_device_pass(trees):
    root = trees[0]
    _assert_trees(root / "port_dev", root / "jax_dev", spec_atol=1e-4,
                  spectral_rtol_stats=1e-5, spec_floor_atol=2e-2, energy_atol=1e-4)


def test_device_pass_against_the_host_pass(trees):
    """The JAX package's own tolerances (``test_on_device_spec_matches_host``);
    the 0.4 s utterance shares its 64-hop bucket with longer ones."""
    root = trees[0]
    assert (root / "port_dev" / "spec").is_dir()
    for kind, atol in (("spec", 2e-2), ("energy", 1e-1)):
        host = sorted((root / "port" / kind).glob("*.npy"))
        assert len(host) == 9
        for h in host:
            a, b = np.load(root / "port_dev" / kind / h.name), np.load(h)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_loaders_read_each_others_trees(trees):
    root, cfg, _ = trees
    items = load_filelist(root / "port" / "training_filelist.psv")
    lookups = ({"default": 0}, {"default": 0})
    for reader_tree, want_tree in (("port", "jax"), ("jax", "port")):
        jcfg = JConfig.model_validate(_with(cfg, root / reader_tree))
        pcfg = FastSpeech2Config.from_dict(_with(cfg, root / want_tree))
        want = list(JBucketedLoader(JFastSpeechDataset(items, jcfg, *lookups), batch_size=2,
                                    n_buckets=2, seed=3))
        got = list(BucketedLoader(FastSpeechDataset(items, pcfg, *lookups), batch_size=2,
                                  n_buckets=2, seed=3))
        assert len(got) == len(want) >= 3
        for g, w in zip(got, want):
            assert g["basename"] == w["basename"]
            for key in ("text", "src_lens", "mel", "mel_lens", "pitch", "energy",
                        "attn_prior", "sample_weight"):
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=ARTIFACT_ATOL,
                                           err_msg=key)


@pytest.mark.parametrize("spec_type", ["linear", "raw"])
def test_other_spec_types_on_device_use_the_host_path(tmp_path, trees, capsys, spec_type):
    """The device pass is log-mel only: a linear or raw spec type prints the
    JAX package's note and takes the host path, which writes what the JAX
    package writes (for raw the complex STFT)."""
    root, cfg, _ = trees
    trees_cfg = {}
    for name in ("port", "jax"):
        c = _with(cfg, tmp_path / name)
        c["preprocessing"]["audio"]["spec_type"] = spec_type
        c["preprocessing"]["source_data"] = c["preprocessing"]["source_data"][1:]
        trees_cfg[name] = c
    Preprocessor(FastSpeech2Config.from_dict(trees_cfg["port"])).run(
        steps=("spec", "energy"), compute_stats=False, on_device_spec=True)
    assert "using the host path" in capsys.readouterr().out
    JPreprocessor(JConfig.model_validate(trees_cfg["jax"])).run(
        steps=("spec", "energy"), compute_stats=False, on_device_spec=True)
    name = f"s0--default--default--spec-22050-{spec_type}.npy"
    spec, want = np.load(tmp_path / "port" / "spec" / name), np.load(tmp_path / "jax" / "spec" / name)
    assert spec.shape[0] == 513 and spec.dtype == want.dtype
    assert np.iscomplexobj(spec) == (spec_type == "raw")
    np.testing.assert_allclose(spec, want, rtol=0, atol=ARTIFACT_ATOL)
    _assert_trees(tmp_path / "port", tmp_path / "jax")


# -- config overrides ------------------------------------------------------------

# the last ten once exited 2 here; JAX reads them as a mapping, a list, a date,
# an anchored or tagged scalar, a comment-trimmed one, an empty block scalar,
# and (where safe_load raises) the raw string
OVERRIDE_CASES = ["yes", "no", "on", "off", "True", "FALSE", "~", "null", "", "1e3", "1.0e3",
                  "1.0e+3", "1.5", ".5", "-.5", "+1", "010", "0x1f", "0b101", "1_000", "1:30",
                  "[1, 2]", "[a, [b, 'c d'], yes, ~]", "[]", '"quoted: yes"', "'it''s'",
                  "mel-librosa", "./rel/path", "0", "-0", "1.0e-3", ".inf", "tRue", "a b",
                  "{a: 1}", "a: b", "2020-01-01", "&x 1", "!!str 1", "a #c", "[1, 2", "- a", "|",
                  "[{a: 1}]"]


@pytest.mark.parametrize("value", OVERRIDE_CASES)
def test_override_values_equal_jax_apply_overrides(value):
    got = apply_overrides({"training": {"x": 0}}, [f"training.a.b={value}", "model.m=3"])
    want = j_apply_overrides({"training": {"x": 0}}, [f"training.a.b={value}", "model.m=3"])
    assert got == want and type(got["training"]["a"]["b"]) is type(want["training"]["a"]["b"])


def test_a_flow_mapping_override_reaches_the_config_as_in_jax(tmp_path, monkeypatch):
    """``preprocess c.json -c 'training.a={a: 1}'`` runs, with the override's
    dict the one JAX's ``apply_overrides`` makes, and a mapping override of a
    field (``text.to_replace``) gives the config JAX's loader gives."""
    (tmp_path / "c.json").write_text(json.dumps({"preprocessing": {"save_dir": "pre"}}))
    overrides = ["training.a={a: 1}", "text.to_replace={x: y}"]
    raw, seen = [], []
    real = config_module.apply_overrides
    monkeypatch.setattr(config_module, "apply_overrides",
                        lambda d, o: raw.append(real(d, o)) or raw[-1])
    monkeypatch.setattr(Preprocessor, "run", lambda self, **kw: seen.append(self.config) or
                        {"n_train": 0, "n_val": 0})
    argv = ["preprocess", str(tmp_path / "c.json")] + [a for o in overrides for a in ("-c", o)]
    code, out = _port_cli(argv)
    assert code == 0, out
    assert raw == [j_apply_overrides({"preprocessing": {"save_dir": "pre"}}, overrides)]
    assert raw[0]["training"]["a"] == {"a": 1}
    want = j_load_config(tmp_path / "c.json", overrides)
    assert seen[0].text.to_replace == dict(want.text.to_replace) == {"x": "y"}


def test_config_overrides_and_relative_paths(tmp_path, monkeypatch):
    """save_dir resolves against the config's folder; source_data's data_dir
    and filelist stay as written (read from the working directory), as the
    JAX config keeps them, here from a working directory other than the
    config's folder."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "elsewhere").mkdir()
    (tmp_path / "sub" / "c.json").write_text(json.dumps({"preprocessing": {
        "save_dir": "pre", "source_data": [{"data_dir": "wavs", "filelist": "list.psv"},
                                           {"data_dir": "./more/wavs", "filelist": "../x.psv"}]}}))
    monkeypatch.chdir(tmp_path / "elsewhere")
    cfg = load_config_base_command(tmp_path / "sub" / "c.json",
                                   ["preprocessing.train_split=0.5", "preprocessing.cpus=3",
                                    "preprocessing.save_dir=other"])
    base = (tmp_path / "sub").resolve()
    assert cfg.preprocessing.save_dir == str(base / "other")
    assert (cfg.preprocessing.train_split, cfg.preprocessing.cpus) == (0.5, 3)
    jcfg = JConfig.load_config_from_path(tmp_path / "sub" / "c.json")
    assert str(jcfg.preprocessing.save_dir) == str(base / "pre")
    port = FastSpeech2Config.from_file(tmp_path / "sub" / "c.json")
    assert port.preprocessing.save_dir == str(base / "pre")
    got = [(Path(s.data_dir), Path(s.filelist)) for s in port.preprocessing.source_data]
    want = [(Path(s.data_dir), Path(s.filelist)) for s in jcfg.preprocessing.source_data]
    assert got == want == [(Path("wavs"), Path("list.psv")), (Path("more/wavs"), Path("../x.psv"))]
    # both read the same files: the working directory's, not the config's folder's
    assert [p.resolve() for p, _ in got] == [(tmp_path / "elsewhere" / "wavs").resolve(),
                                             (tmp_path / "elsewhere" / "more/wavs").resolve()]
    assert cfg.preprocessing.source_data[0].filelist == "list.psv"
    with pytest.raises(ValueError, match="key.path=value"):
        load_config_base_command(tmp_path / "sub" / "c.json", ["nothing"])


# -- CLIs ------------------------------------------------------------------------


def _port_cli(argv):
    """(exit code, stderr + stdout) of the port's CLI in this process."""
    out = io.StringIO()
    with contextlib.redirect_stderr(out), contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as e:
            return e.code, out.getvalue()
    return 0, out.getvalue()


def test_preprocess_cli_equals_the_jax_cli(trees, tmp_path):
    root, cfg, _ = trees
    for name in ("jax", "port"):
        (tmp_path / f"{name}.json").write_text(json.dumps(_with(cfg, tmp_path / name)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        res = CliRunner().invoke(jax_app, ["preprocess", str(tmp_path / "jax.json"), "-s",
                                           "spec", "-s", "pitch", "-s", "text", "--cpus", "1",
                                           "-c", "preprocessing.train_split=0.5"])
    assert res.exit_code == 0, res.output
    code, out = _port_cli(["preprocess", str(tmp_path / "port.json"), "-s", "spec", "-s",
                           "pitch", "-s", "text", "--cpus", "1", "--host-spec",
                           "-c", "preprocessing.train_split=0.5"])
    assert code == 0, out
    assert out.strip() == res.output.strip().replace(str(tmp_path / "jax"),
                                                     str(tmp_path / "port"))
    _assert_trees(tmp_path / "port", tmp_path / "jax")
    assert not (tmp_path / "port" / "audio").exists()


USAGE = {
    "missing config": ["preprocess", "{tmp}/none.json"],
    "bad step": ["preprocess", "{cfg}", "-s", "mfcc"],
    "bad cpus": ["preprocess", "{cfg}", "--cpus", "many"],
    "missing filelist": ["check-data", "{cfg}", "-f", "{tmp}/none.psv"],
    "check-data missing config": ["check-data", "{tmp}/none.json"],
    "convert missing dir": ["convert-artifacts", "{tmp}/none"],
}


@pytest.mark.parametrize("case", list(USAGE))
def test_usage_errors_match_the_jax_cli(tmp_path, case):
    (tmp_path / "c.json").write_text("{}")
    args = [a.format(tmp=tmp_path, cfg=tmp_path / "c.json") for a in USAGE[case]]
    res = CliRunner().invoke(jax_app, args)
    assert res.exit_code == 2, res.output
    code, err = _port_cli(args)
    assert code == 2, err
    message = res.output.split("Error: ", 1)[1].strip()
    if "does not exist" in message:  # the same words
        assert " ".join(err.split()).endswith("error: " + " ".join(message.split())), err
    else:  # click's and argparse's words for a bad choice or integer differ
        assert "invalid" in err.lower()


def test_convert_artifacts_equals_the_jax_command(tmp_path):
    rng = np.random.default_rng(8)
    src = tmp_path / "src"
    for kind, arr in (("spec", rng.standard_normal((20, 33)).astype(np.float32)),
                      ("pitch", rng.standard_normal(33).astype(np.float32)),
                      ("text", np.arange(9, dtype=np.int64)),
                      ("duration", rng.integers(0, 5, 9)),
                      ("attn", rng.random((33, 9)).astype(np.float64))):
        (src / kind).mkdir(parents=True)
        torch.save(torch.from_numpy(arr), src / kind / f"u0--default--default--{kind}.pt")
    torch.save([1.5, 2.5], src / "energy.pt")  # not under an artifact folder
    (src / "energy").mkdir()
    torch.save({"not": "a tensor"}, src / "energy" / "u0--default--default--energy.pt")
    np.save(src / "pitch" / "u1--default--default--pitch.npy", np.zeros(3, np.float32))
    torch.save(torch.ones(3), src / "pitch" / "u1--default--default--pitch.pt")
    for flags, counts in (([], "converted 5 artifacts, skipped 2"),
                          (["--overwrite"], "converted 6 artifacts, skipped 1")):
        jdir, pdir = tmp_path / f"jax{len(flags)}", tmp_path / f"port{len(flags)}"
        shutil.copytree(src, jdir)
        shutil.copytree(src, pdir)
        res = CliRunner().invoke(jax_app, ["convert-artifacts", str(jdir), "-V", *flags])
        assert res.exit_code == 0, res.output
        code, out = _port_cli(["convert-artifacts", str(pdir), "-V", *flags])
        assert code == 0, out
        assert out == res.output.replace(str(jdir), str(pdir))
        want, got = _tree(jdir), _tree(pdir)
        assert sorted(got) == sorted(want)
        for name, path in want.items():
            if name.endswith(".npy"):
                a, b = np.load(got[name]), np.load(path)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert counts in out


def test_filelist_helpers_equal_jax(tmp_path):
    from fastspeech2_lightning_tpu import utils as jutils
    from fastspeech2_lightning_tpu_torch.text import lookups

    rows = [{"basename": "a", "text": "x|y"}, {"basename": "b", "speaker": "s1"}]
    write_filelist(rows, tmp_path / "p.psv")
    jutils.write_filelist(rows, tmp_path / "j.psv")
    assert (tmp_path / "p.psv").read_bytes() == (tmp_path / "j.psv").read_bytes()
    (tmp_path / "plain.txt").write_text("one\n\ntwo\n")
    for path in ("p.psv", "plain.txt"):
        assert load_filelist(tmp_path / path) == jutils.load_filelist(tmp_path / path)
    assert lookups.load_filelist is load_filelist
    write_filelist([], tmp_path / "empty.psv")
    assert (tmp_path / "empty.psv").read_text() == ""
