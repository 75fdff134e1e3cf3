"""The served model: a ``Synthesizer`` built from seeded weights in memory,
hooks that record what its timed path produced, and the check of a sample
of its batches against the plain reference.

The benchmark wraps the synthesizer's ``synthesize`` and its vocoder's
``device_fn`` on the instance (the program is not edited): each call's
texts, durations, mels and wavs, and the vocoder's input and output, are
kept for a sample of the calls drawn from the seed (reservoir sampling) and
for the call holding the longest text. Once the window has closed the
reference runs on those calls:

- ``duration_cell_gap``: how far a served symbol's duration lies outside
  the rounding cell of the reference's predicted duration, the widest gap
  (the durations set every row's frames, and with them the audio counted);
- ``mel_rel_l2``: the served mel against the reference's at the served
  durations, on each row's frames, the worst row;
- ``vocoded_mel_gap``: the largest difference between a served mel and the
  rows of it that the vocoder was given (exact: the wav is made of the mel
  that is returned);
- ``wav_rel_l2``: the served wav against the reference vocoder's on the mel
  the program's vocoder was given, on each row's samples, the worst row.

So the reference follows the program stage by stage: the durations from
the text, the mel at the served durations, the wav from the served mel.
Each stage is held to the reference on its own, and the hand-over between
the last two is held exact.

The served vocoder is float32 as PyTorch runs it on a card by default: its
cuDNN convs in TF32 (``torch.backends.cudnn.allow_tf32``, which the port
leaves on) and its MRF stages in the port's kernels at float32 accuracy. The
reference computes the same arithmetic: every conv's operands rounded to
TF32, the MRF stages' convs in float32 (``Numerics("tf32")`` and
``Numerics("float32")``); its control takes bfloat16 for both."""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import List, Optional

import numpy as np
import torch

from . import acoustic, corpus, weights
from .vocoder import generator_rules
from ..reference import fastspeech2 as ref_fs2
from ..reference import hifigan as ref_voc
from ..reference.numerics import Numerics, strict_float32
from .harness import Check

MEL_KEY = "postnet_output"


def build(run, cfg: dict, max_frames: Optional[int] = None):
    """(synthesizer, vocoder weights) on the run's device."""
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.models.hifigan import HiFiGANConfig, make_vocoder_fn
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
    from fastspeech2_lightning_tpu_torch.type_definitions import Stats

    dev = run.device
    config = FastSpeech2Config.from_dict(cfg)
    model = FastSpeech2(config, n_symbols=corpus.n_symbols())
    named = dict(model.named_parameters())
    params, extra, bins = acoustic_weights(cfg, run.seed, dev)
    if set(named) != set(params):
        raise RuntimeError(f"the program's parameters differ from the reference's: "
                           f"{sorted(set(named) ^ set(params))[:6]}")
    model = model.to(dev)
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for k, v in params.items():
            named[k].copy_(v)
        for k, v in extra.items():
            buffers[k].copy_(v)
        for kind, b in bins.items():
            buffers[f"variance_adaptor.{kind}_bins"].copy_(b)
    model.eval()
    v = cfg_vocoder(run)
    vp = weights.make(generator_rules(v), run.seed + 3, dev)
    gen_cfg = HiFiGANConfig(**{k: tuple(tuple(x) if isinstance(x, list) else x for x in val)
                               if isinstance(val, list) else val for k, val in v.items()})
    vocoder = make_vocoder_fn({k: t.cpu() for k, t in vp.items()}, gen_cfg,
                              precision="float32", fused=True, device=dev)
    stats = Stats.from_dict(corpus.STATS)
    synth = Synthesizer(model, config, stats, {}, {}, vocoder=vocoder, max_frames=max_frames)
    return synth


def acoustic_weights(cfg: dict, seed: int, device) -> tuple:
    """(parameters, BatchNorm statistics, variance bins) of the served
    model. What sets the durations (``acoustic.DURATION_PATH``: the text
    embedding, the encoder, the variance predictors and embeddings) is drawn
    from the fixed generator of sizes and its duration head calibrated, so
    every run synthesizes as many frames of each text; the rest (decoder,
    PostNet) is drawn from `seed`. With the whole model drawn from the seed
    the durations follow each draw's own trend along the text (the long
    texts' 5.5 to 7.3 frames a symbol over two seeds), and with them the
    padded vocoder work (throughput 803-918 s/s over six seeds, two runs of
    one seed within 2 %)."""
    fixed = corpus.SIZE_SEED
    rules, brules = acoustic.weight_rules(cfg), acoustic.buffer_rules(cfg)
    params = weights.make({k: v for k, v in rules.items() if not acoustic.on_duration_path(k)},
                          seed, device)
    params.update(weights.make({k: v for k, v in rules.items() if acoustic.on_duration_path(k)},
                               fixed, device))
    buffers = weights.make({k: v for k, v in brules.items() if not acoustic.on_duration_path(k)},
                           seed + 2, device)
    buffers.update(weights.make({k: v for k, v in brules.items()
                                 if acoustic.on_duration_path(k)}, fixed + 2, device))
    acoustic.calibrate_duration(params, buffers, cfg, device)
    return {k: params[k] for k in rules}, buffers, acoustic.variance_bins(cfg, device)


def cfg_vocoder(run) -> dict:
    return run.config["vocoder"]


@dataclasses.dataclass
class Served:
    texts: List[str]
    durations: List[np.ndarray]
    mels: List[np.ndarray]
    wavs: List[np.ndarray]
    voc_in: torch.Tensor
    voc_out: torch.Tensor
    lens: List[int]


class Recorder:
    """Wraps ``synth.synthesize`` and ``synth.vocoder.device_fn``: counts
    calls, forwards and rows, records the traced calls' shapes, and keeps a
    sample of `keep` calls (and the longest text's) for the check."""

    def __init__(self, synth, seed: int, keep: int = 3):
        self.synth, self.keep = synth, keep
        self.rng = np.random.default_rng(seed % (1 << 63))
        self.lock = threading.Lock()
        self.calls = self.forwards = 0
        self.items: List[Served] = []
        self.longest: Optional[Served] = None
        self.tracing = False
        self.traced: List[dict] = []
        self.work: List[dict] = []  # per counted call: real (L, T) items and vocoder frames
        self.counting = False
        self._local = threading.local()
        inner_syn, inner_voc = synth.synthesize, synth.vocoder.device_fn
        synth.model.register_forward_hook(self._forward_hook)

        def device_fn(mel):
            out = inner_voc(mel)
            self._local.voc = (mel, out)
            if self.tracing:
                self.traced.append({"vocoder_in": tuple(mel.shape)})
            return out

        def synthesize(texts, *args, **kwargs):
            self._local.voc = None
            result = inner_syn(texts, *args, **kwargs)
            self._record(texts, result)
            return result

        synth.vocoder.device_fn = device_fn
        synth.synthesize = synthesize

    def _forward_hook(self, module, inputs, output):
        with self.lock:
            if self.counting:
                self.forwards += 1

    def _record(self, texts, result) -> None:
        mel_in, wav_out = self._local.voc
        lens = [len(m) for m in result.mels]
        item = Served(list(texts), result.durations, result.mels, result.wavs, mel_in, wav_out,
                      lens)
        with self.lock:
            if not self.counting:
                return
            self.calls += 1
            # rows after the first that repeat it are the batcher's fill
            real = [(len(corpus.encode(t)), n) for i, (t, n) in enumerate(zip(texts, lens))
                    if i == 0 or t != texts[0]]
            self.work.append({"items": real, "vocoder_in": tuple(mel_in.shape)})
            n = self.calls
            if self.longest is None or max(map(len, texts)) > max(map(len, self.longest.texts)):
                self.longest = item
            if len(self.items) < self.keep:
                self.items.append(item)
            else:
                j = int(self.rng.integers(n))
                if j < self.keep:
                    self.items[j] = item

    def sample(self) -> List[Served]:
        out = list(self.items)
        if self.longest is not None and all(s is not self.longest for s in out):
            out.append(self.longest)
        return out


def plant(synth, fault: Optional[str]) -> None:
    """Harness tests, underneath the synthesizer: ``alter_wav`` scales every
    wav the vocoder produces by 1.01, ``alter_vocoder_input`` every mel the
    vocoder is given (the returned mel unchanged), ``stretch_durations``
    every call's durations by 1.5 (the model's duration control)."""
    if fault in ("alter_wav", "alter_vocoder_input"):
        inner = synth.vocoder.device_fn
        if fault == "alter_wav":
            synth.vocoder.device_fn = lambda mel: inner(mel) * 1.01
        else:
            synth.vocoder.device_fn = lambda mel: inner(mel * 1.01)
    elif fault == "stretch_durations":
        inner_syn = synth.synthesize
        synth.synthesize = lambda texts, *a, **k: inner_syn(texts, *a, **dict(
            k, duration_control=1.5))


def vocoder_convs(device) -> Numerics:
    """The arithmetic of the served vocoder's cuDNN convs: TF32 on a card
    where cuDNN may take it (PyTorch's default), float32 elsewhere."""
    tf32 = device.type == "cuda" and torch.backends.cudnn.allow_tf32
    return Numerics("tf32" if tf32 else "float32")


def reference_outputs(run, cfg: dict, served: List[Served], fwd: Numerics, voc: Numerics,
                      voc_convs: Optional[Numerics] = None) -> List[dict]:
    """The reference's log-durations, mel at the served durations and wav of
    the served vocoder input, for each kept call."""
    dev = run.device
    out = []
    voc_convs = voc_convs or vocoder_convs(dev)
    with strict_float32():
        params, buffers, bins = acoustic_weights(cfg, run.seed, dev)
        vp = weights.make(generator_rules(cfg_vocoder(run)), run.seed + 3, dev)
        model = ref_fs2.Model(params, cfg, fwd, buffers)
        with torch.no_grad():
            for s in served:
                ids = [corpus.encode(t) for t in s.texts]
                L = acoustic.round_up(max(map(len, ids)), 16)
                B = len(ids)
                text = torch.zeros(B, L, dtype=torch.long, device=dev)
                dur = torch.zeros(B, L, dtype=torch.long, device=dev)
                for i, (e, d) in enumerate(zip(ids, s.durations)):
                    text[i, :len(e)] = torch.as_tensor(e)
                    dur[i, :len(d)] = torch.as_tensor(np.asarray(d, np.int64))
                src = torch.as_tensor([len(e) for e in ids], device=dev)
                T = acoustic.round_up(max(s.lens) + 32, 128)
                r = model.forward_inference(text, src, dur, T, bins)
                wav = ref_voc.generator(vp, s.voc_in.float(), cfg_vocoder(run), voc_convs,
                                        num_mrf=voc)
                out.append({"logdur": r["duration_prediction"].cpu(),
                            "mel": r[MEL_KEY].cpu(), "wav": wav.cpu(), "src": src.cpu()})
    return out


def compare(served: List[Served], want: List[dict], hop: int, limits: dict) -> List[Check]:
    dur_gap = mel_gap = voc_in_gap = wav_gap = 0.0
    for s, w in zip(served, want):
        voc_in = s.voc_in.float().cpu()
        for i in range(len(s.texts)):
            n = int(w["src"][i])
            x = np.maximum(np.exp(w["logdur"][i, :n].double().numpy()) - 1.0, 0.0)
            d = np.asarray(s.durations[i][:n], np.float64)
            dur_gap = max(dur_gap, float(np.max(np.maximum(np.abs(x - d) - 0.5, 0.0))))
            T = s.lens[i]
            mp, mr = torch.as_tensor(s.mels[i][:T]).double(), w["mel"][i, :T].double()
            mel_gap = max(mel_gap, float((mp - mr).norm() / mr.norm().clamp_min(1e-30)))
            given = voc_in[i, :T].double()
            voc_in_gap = max(voc_in_gap, float((mp - given).abs().max())
                             if given.shape == mp.shape else math.inf)
            wp = torch.as_tensor(s.wavs[i][:T * hop]).double()
            wr = w["wav"][i, :T * hop].double()
            wav_gap = max(wav_gap, float((wp - wr).norm() / wr.norm().clamp_min(1e-30)))
    return [Check("duration_cell_gap", dur_gap, limits["duration_cell_gap"]),
            Check("mel_rel_l2", mel_gap, limits["mel_rel_l2"]),
            Check("vocoded_mel_gap", voc_in_gap, limits["vocoded_mel_gap"]),
            Check("wav_rel_l2", wav_gap, limits["wav_rel_l2"])]


def control_served(run, cfg: dict, batches: List[List[str]], fwd_mode: str, voc_mode: str,
                   hop: int) -> List[Served]:
    """The reference in lower precisions put in the program's place on
    `batches` of texts: its own rounded durations, its mel at them, and its
    vocoder's wav of that mel trimmed as the synthesizer trims it."""
    dev = run.device
    out = []
    with strict_float32():
        params, buffers, bins = acoustic_weights(cfg, run.seed, dev)
        vp = weights.make(generator_rules(cfg_vocoder(run)), run.seed + 3, dev)
        model = ref_fs2.Model(params, cfg, Numerics(fwd_mode), buffers)
        with torch.no_grad():
            for texts in batches:
                ids = [corpus.encode(t) for t in texts]
                L = acoustic.round_up(max(map(len, ids)), 16)
                text = torch.zeros(len(ids), L, dtype=torch.long, device=dev)
                for i, e in enumerate(ids):
                    text[i, :len(e)] = torch.as_tensor(e)
                src = torch.as_tensor([len(e) for e in ids], device=dev)
                mask = torch.arange(L, device=dev)[None] < src[:, None]
                zero = torch.zeros_like(text)
                logdur = model.forward_inference(text, src, zero, 16, bins)["duration_prediction"]
                dur = torch.clamp(torch.round(torch.exp(logdur) - 1.0), min=0).long() * mask
                lens = [int(n) for n in dur.sum(1).clamp(max=cfg["model"]["max_mel_length"])]
                T = acoustic.round_up(max(lens) + 32, 128)
                mel = model.forward_inference(text, src, dur, T, bins)[MEL_KEY]
                voc_in = mel[:, :acoustic.round_up(max(lens), 128)]
                wav = ref_voc.generator(vp, voc_in, cfg_vocoder(run), Numerics(voc_mode))
                out.append(Served(list(texts), [dur[i, :len(e)].cpu().numpy()
                                                for i, e in enumerate(ids)],
                                  [mel[i, :n].cpu().numpy() for i, n in enumerate(lens)],
                                  [wav[i, :n * hop].cpu().numpy() for i, n in enumerate(lens)],
                                  voc_in, wav, lens))
    return out
