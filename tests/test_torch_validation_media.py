"""The port's validation media against the JAX trainer's, without a JAX
training run.

The port's tiny model (``helpers.make_training_workspace``, f32, PostNet on)
validates twice on the CPU, at step 0 and step 3, with ``training.vocoder_path``
set (relative to the YAML config) to a small HiFiGAN whose output spans
hundreds of PCM16 steps. Each first validation batch and the port's outputs
for it (as numpy) go through the JAX ``Trainer._log_validation_media``,
called unbound on a stand-in with the JAX config, stats, a recording writer
and a ``state`` with ``.step``; JAX's ``plot_attn_maps`` and ``plot_mel`` are
replaced in this test by recorders of their inputs. Then:

- the port's event file holds the tags JAX hands its writer, at the same
  steps, and ``validation/<k>_loss`` equal to ``val_log.jsonl``'s;
- the arrays the port draws equal JAX's plot inputs exactly (the attention
  maps, both mels, the expanded pitch and energy);
- the heatmaps read back from the port's PNGs through the colormap equal the
  min-max-normalised arrays within 1/255, and each curve's pixel row is
  JAX's normalised height, rounded;
- the audio equals what JAX hands ``add_audio`` (the vocoder's output on the
  same ``vocoder.npz``; at step 0 also the preprocessed wav and the GT mel
  vocoded) within the vocoder parity tolerance (1e-5) plus one PCM16 step.
"""

import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from fastspeech2_lightning_tpu.config import FastSpeech2Config as JConfig
from fastspeech2_lightning_tpu.models.hifigan import HiFiGANConfig, init_random_hifigan
from fastspeech2_lightning_tpu.testing import dataclass_to_dict
from fastspeech2_lightning_tpu.training.loop import Trainer as JTrainer
from fastspeech2_lightning_tpu.type_definitions import Stats as JStats
from fastspeech2_lightning_tpu.utils import plotting as jplotting
from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
from fastspeech2_lightning_tpu_torch.training.loop import Trainer
from fastspeech2_lightning_tpu_torch.utils import plotting
from fastspeech2_lightning_tpu_torch.utils import tensorboard as tb

from helpers import make_training_workspace

torch.set_num_threads(2)
STEPS = (0, 3)
VOCODER_ATOL = 1e-5  # the port's vocoder against JAX's (tests/test_torch_vocoder_training.py)
PCM_TOL = VOCODER_ATOL * 32767 + 1  # ... plus one PCM16 step
VOCODER_GAIN = 4.0  # the stub vocoder's weights times this: outputs of 1e-3 and more, not ~1e-6


class _Recorder:
    """The JAX trainer's writer, recording what it is handed."""

    def __init__(self):
        self.calls = []

    def add_figure(self, tag, fig, step):
        self.calls.append(("figure", tag, step, fig))

    def add_audio(self, tag, wav, step, sample_rate):
        self.calls.append(("audio", tag, step, (np.asarray(wav), sample_rate)))


def _pcm(x) -> np.ndarray:
    return np.round(np.clip(np.asarray(x, np.float64).reshape(-1), -1, 1) * 32767)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    make_training_workspace(root, n_utts=6, batch_size=2,
                            model_overrides={"dtype": "float32", "use_postnet": True})
    voc = HiFiGANConfig(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 3),), n_mels=20)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) * VOCODER_GAIN,
                                    init_random_hifigan(voc))
    (root / "vocoders").mkdir()
    np.savez(root / "vocoders" / "voc.npz", params=np.array(params, dtype=object),
             config=np.array(dataclass_to_dict(voc), dtype=object), global_step=0)
    raw = yaml.safe_load((root / "config.yaml").read_text())
    raw["training"]["vocoder_path"] = "vocoders/voc.npz"  # relative to the config file
    path = root / "media.yaml"
    path.write_text(yaml.safe_dump(raw))
    config = FastSpeech2Config.from_file(path)
    jconfig = JConfig.load_config_from_path(path)

    # the port: two validations, recording the media's batch and outputs and
    # the arrays the plots are handed
    trainer = Trainer(config, device="cpu", log_dir=root / "port_logs")
    handed, drawn = [], {"attn": [], "mel": []}
    media = trainer._log_validation_media

    def spy_media(step, batch, out):
        handed.append((step, batch, {k: v.detach().cpu().numpy() for k, v in out.items()
                                     if isinstance(v, torch.Tensor)}))
        return media(step, batch, out)

    def recorder(kind, fn):
        def wrapped(*args, **kwargs):
            drawn[kind].append(args)
            return fn(*args, **kwargs)
        return wrapped

    trainer._log_validation_media = spy_media
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plotting, "plot_attn_maps", recorder("attn", plotting.plot_attn_maps))
        mp.setattr(plotting, "plot_mel", recorder("mel", plotting.plot_mel))
        for step in STEPS:
            trainer.validate(step, 0)
    trainer.close()
    (event_file,) = (root / "port_logs").glob("events.out.tfevents.*")

    # JAX: the media method unbound, on the same batches and outputs
    jdrawn = {"attn": [], "mel": []}
    writer = _Recorder()
    stand_in = types.SimpleNamespace(
        config=jconfig, writer=writer,
        stats=JStats(**json.loads((Path(config.preprocessing.save_dir) / "stats.json")
                                  .read_text())))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jplotting, "plot_attn_maps",
                   lambda *a, **k: jdrawn["attn"].append(a) or [object()] * k.get("n", 1))
        mp.setattr(jplotting, "plot_mel", lambda *a, **k: jdrawn["mel"].append(a) or object())
        for step, batch, out in handed:
            JTrainer._log_validation_media(stand_in, types.SimpleNamespace(step=step), batch,
                                           out)
    return dict(config=config, trainer=trainer, handed=handed, drawn=drawn, jdrawn=jdrawn,
                jcalls=writer.calls, events=tb.read_events(event_file), stats=stand_in.stats)


def _media(events):
    return [(e["step"], v) for e in events for v in e.get("summary", ())
            if "simple_value" not in v]


def test_the_event_file_holds_the_tags_jax_hands_its_writer(runs):
    got = sorted((s, v["tag"]) for s, v in _media(runs["events"]))
    want = sorted((step, tag) for _, tag, step, _ in runs["jcalls"])
    name = runs["handed"][0][1]["basename"][0]
    expected = sorted([(s, f"{kind}{name}") for s in STEPS
                       for kind in ("attention/", "pred/spec_", "pred/wav_")]
                      + [(0, f"gt/wav_{name}"), (0, f"copy-synthesis/wav_{name}")])
    assert got == want == expected


def test_validation_scalars_equal_val_log(runs):
    rows = [json.loads(line) for line in
            (runs["trainer"].log_dir / "val_log.jsonl").read_text().splitlines()]
    got = tb.scalars(runs["events"])
    assert [r["step"] for r in rows] == list(STEPS)
    for k in ("total", "spec", "postnet", "pitch", "energy", "duration", "attn_ctc"):
        assert got[f"validation/{k}_loss"] == [(r["step"], float(np.float32(r[k]))) for r in rows]


def test_the_port_draws_jaxs_plot_inputs(runs):
    drawn, jdrawn = runs["drawn"], runs["jdrawn"]
    assert len(drawn["attn"]) == len(jdrawn["attn"]) == len(STEPS)
    for (soft, hard, mel_lens, text_lens), (jsoft, jhard, jmel_lens, jtext_lens) in zip(
            drawn["attn"], jdrawn["attn"]):
        t, l = int(jmel_lens[0]), int(jtext_lens[0])
        assert (int(mel_lens[0]), int(text_lens[0])) == (t, l)
        np.testing.assert_array_equal(soft[0, :t, :l], jsoft[0, :t, :l])
        np.testing.assert_array_equal(hard[0, :t, :l], jhard[0, :t, :l])
    assert len(drawn["mel"]) == len(jdrawn["mel"]) == len(STEPS)
    for (entries, stats, _), (jentries, jstats, _) in zip(drawn["mel"], jdrawn["mel"]):
        assert stats.pitch.std == jstats.pitch.std and stats.energy.max == jstats.energy.max
        for e, je in zip(entries, jentries, strict=True):
            for key in ("mel", "pitch", "energy"):
                np.testing.assert_array_equal(np.asarray(e[key]), np.asarray(je[key]),
                                              err_msg=key)


def _images(runs, prefix):
    return [(s, tb.decode_png(v["image"]["encoded_image_string"]), v["image"])
            for s, v in _media(runs["events"]) if v["tag"].startswith(prefix)]


_INDEX = {tuple(rgb): i for i, rgb in enumerate(plotting.COLORMAP.tolist())}


def _read_heatmap(pixels: np.ndarray, scale: int) -> tuple:
    """(normalised values idx/255 with row 0 at the bottom, mask of the
    cells whose pixel is not a colormap colour) of a panel."""
    cells = pixels[::scale, ::scale][::-1]
    idx = np.array([[_INDEX.get(tuple(p), -1) for p in row] for row in cells.tolist()])
    return idx / 255.0, idx < 0


def _normalised(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return (a - a.min()) / (a.max() - a.min()) if a.max() > a.min() else np.zeros_like(a)


def test_attention_png_reads_back_to_the_normalised_maps(runs):
    images = _images(runs, "attention/")
    assert len(images) == len(STEPS)
    for (step, image, meta), (jsoft, jhard, jmel_lens, jtext_lens) in zip(
            images, runs["jdrawn"]["attn"]):
        t, l = int(jmel_lens[0]), int(jtext_lens[0])
        s = plotting.scale_for(t, l)
        assert image.shape == (l * s, 2 * t * s + plotting.GAP, 3)
        assert (meta["height"], meta["width"]) == image.shape[:2]
        for k, a in enumerate((jsoft, jhard)):
            panel = image[:, k * (t * s + plotting.GAP):k * (t * s + plotting.GAP) + t * s]
            values, foreign = _read_heatmap(panel, s)
            assert not foreign.any()
            np.testing.assert_allclose(values, _normalised(a[0, :t, :l].T), atol=1 / 255)


def test_mel_png_reads_back_to_the_mels_and_curves(runs):
    images = _images(runs, "pred/spec_")
    stats = runs["stats"]
    for (step, image, _), (entries, _, _) in zip(images, runs["jdrawn"]["mel"]):
        k, t = entries[0]["mel"].shape
        s = plotting.scale_for(*(max(e["mel"].shape) for e in entries))
        assert image.shape == (2 * k * s + plotting.GAP, t * s, 3)
        for n, e in enumerate(entries):
            panel = image[n * (k * s + plotting.GAP):n * (k * s + plotting.GAP) + k * s]
            values, foreign = _read_heatmap(panel, s)
            np.testing.assert_allclose(values[~foreign], _normalised(e["mel"])[~foreign],
                                       atol=1 / 255)
            rows = {}
            for key, info in (("pitch", stats.pitch), ("energy", stats.energy)):
                x = np.asarray(e[key], np.float64) * info.std + info.mean
                h = (x - info.min) / max(info.max - info.min, 1e-9) * k
                up = np.round(h[:t] * s)  # JAX's normalised height, in pixels from the bottom
                rows[key] = np.where((up >= 0) & (up < k * s), k * s - 1 - up, -1)
            assert all((r >= 0).sum() >= t // 2 for r in rows.values())  # curves in view
            for key, rgb in (("pitch", plotting.PITCH_RGB), ("energy", plotting.ENERGY_RGB)):
                for j in range(t):
                    col = panel[:, j * s]
                    hit = np.flatnonzero((col == rgb).all(1))
                    want = rows[key][j] if j < rows[key].size else -1
                    if key == "pitch" and want >= 0 and rows["energy"][j] == want:
                        want = -1  # energy is drawn over it
                    assert list(hit) == ([int(want)] if want >= 0 else []), (key, j)
            # every pixel off the colormap is a curve's
            curve = np.zeros((k * s, t * s), bool)
            for key in rows:
                for j, r in enumerate(rows[key][:t]):
                    if r >= 0:
                        curve[int(r), j * s:(j + 1) * s] = True
            assert ((~np.isin(panel.reshape(-1, 3).view([("", np.uint8)] * 3),
                              plotting.COLORMAP.view([("", np.uint8)] * 3)))
                    .reshape(k * s, t * s) <= curve).all()


def test_audio_equals_what_jax_hands_its_writer(runs):
    got = {(s, v["tag"]): v["audio"] for s, v in _media(runs["events"]) if "audio" in v}
    want = {(step, tag): clip for kind, tag, step, clip in runs["jcalls"] if kind == "audio"}
    assert sorted(got) == sorted(want) and len(want) == len(STEPS) + 2
    for key, (wav, sr) in want.items():
        audio = got[key]
        pcm, rate = tb.wav_samples(audio["encoded_audio_string"])
        assert (rate, audio["sample_rate"], audio["length_frames"]) == (sr, sr, wav.size)
        assert np.abs(pcm - _pcm(wav)).max() <= (0 if key[1].startswith("gt/") else PCM_TOL)
        assert np.abs(pcm).max() > 30 * PCM_TOL, key  # the clip is far above rounding
    hop = runs["config"].preprocessing.audio.fft_hop_size
    step, batch, out = runs["handed"][0]
    (_, pred), = [(k, v) for k, v in got.items() if k[0] == step and k[1].startswith("pred/")]
    assert pred["length_frames"] == out["postnet_output"].shape[1] * hop  # the padded row


@pytest.mark.parametrize("values, durations", [
    ([1.0, 2.0, 3.0], [2, 0, 3]), ([0.5, -1.0], [1.7, 2.2]), ([4.0, 5.0], [-1, 1]), ([], [])])
def test_expand_equals_jax(values, durations):
    got = plotting.expand(np.array(values), np.array(durations))
    want = jplotting.expand(np.array(values), np.array(durations))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
