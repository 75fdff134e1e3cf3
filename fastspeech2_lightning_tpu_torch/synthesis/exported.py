"""Serving artifacts through ``torch.export`` (counterpart of the JAX
package's ``synthesis/exported.py``).

``export_serving_artifact`` traces the serving program set with
``torch.export`` and writes one ``.fs2x`` zip; ``ExportedSynthesizer`` serves
synthesis from it with no model code and no checkpoint: it loads each
program with ``torch.export.load`` and runs it.

    python -m fastspeech2_lightning_tpu_torch export-serving model.ckpt -o model.fs2x -v hifigan.npz
    synth = ExportedSynthesizer("model.fs2x")
    result = synth.synthesize(["hello world"])    # the same SynthesisResult

Layout (one zip file, JAX's layout and meta keys, ``torch_version`` in place
of ``jax_version``):

    meta.json            format version, platforms, config, stats, lookups,
                         program manifests, audio parameters
    params.pt            the acoustic model's state_dict (the port's names,
                         the reference layout)
    vocoder_params.pt    the HiFiGAN generator's state_dict (with a vocoder)
    acoustic/B{B}_L{L}_T{T}.{platform}.pt2     torch.export programs; the
    vocoder/B{B}_T{T}.{platform}.pt2           weights are call arguments,
    vocoder_streaming/W{window}.{platform}.pt2 not constants

The program set is JAX's, shape for shape: for each batch size B and text
bucket L one acoustic program at T = min(cap, round_up(12 L, 128)), and the
full-cap program for the largest L (the duration-overflow re-run's target);
a vocoder program for each B and each of those T; one B = 1 program for each
streaming window, at window + 2 * margin frames. An acoustic program takes
(params, text, src_lens, speaker_id, language_id, pitch, energy, duration),
the controls as 0-d f32 tensors and, for a phonological-feature model, the
[B, L, N_PHONOLOGICAL_FEATURES] feature matrix as `text`; it returns (mel,
tgt_lens, duration_rounded). The vocoder programs are the unfused HiFiGAN
generator in f32, as JAX exports it: an artifact launches no MRF kernel.

A program bakes its device into its graph (``arange`` and ``full`` take the
trace's device), so every platform gets its own program set: ``cpu``,
``cuda`` or both, the device the export runs on by default. The acoustic
programs call kernel A as the op ``fs2t::attention_fwd``: the kernel on the
card, its plain version on the CPU."""

from __future__ import annotations

import dataclasses
import io
import json
import threading
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import CHARACTERS, PHONOLOGICAL_FEATURES, FastSpeech2Config
from ..dataset import PAD_MULT_TEXT, _round_up
from ..device import resolve_device
from ..text import TextProcessor
from ..text.features import N_PHONOLOGICAL_FEATURES
from ..type_definitions import Stats
from .api import SynthesisResult
from .prepare import chunk_text_for_model, encode_texts_for_model, get_text_split_params

FORMAT_VERSION = "1.0"
PLATFORMS = ("cpu", "cuda")


def _frame_bucket(L: int, cap: int) -> int:
    """The text-length frame estimate of ``Synthesizer.synthesize``."""
    return min(cap, _round_up(12 * L, 128))


def default_text_buckets(config, stats) -> List[int]:
    """Every PAD_MULT_TEXT multiple up to the chunker's longest chunk."""
    _, maxi, _, _ = get_text_split_params(stats, CHARACTERS, config, None)
    top = _round_up(max(int(maxi), PAD_MULT_TEXT), PAD_MULT_TEXT)
    return list(range(PAD_MULT_TEXT, top + 1, PAD_MULT_TEXT))


def parse_platforms(platforms) -> Optional[List[str]]:
    """'cpu', 'cuda', 'cpu,cuda' (or a sequence of names) -> the platform
    list, with 'gpu' read as 'cuda'; None or empty -> None."""
    if not platforms:
        return None
    names = platforms.split(",") if isinstance(platforms, str) else list(platforms)
    out = []
    for name in (n.strip().lower() for n in names if n.strip()):
        name = "cuda" if name == "gpu" else name
        if name == "tpu":
            raise ValueError("platform 'tpu': the PyTorch port exports torch.export programs "
                             "for 'cpu' and 'cuda'; TPU artifacts come from the JAX package "
                             "(fs2t export-serving)")
        if name not in PLATFORMS:
            raise ValueError(f"unknown platform {name!r}; use {', '.join(PLATFORMS)}")
        if name not in out:
            out.append(name)
    return out or None


class _Acoustic(torch.nn.Module):
    """The inference forward at a fixed frame budget as a function of the
    weights: the model is held outside the module tree, so the program
    lifts no parameter and the weights are its first argument."""

    def __init__(self, model, max_target_len: int, mel_key: str):
        super().__init__()
        self.held = [model]
        self.max_target_len = max_target_len
        self.mel_key = mel_key

    def forward(self, params, text, src_lens, speaker_id, language_id, pitch, energy,
                duration):
        model = self.held[0]
        ctrl = {"pitch": pitch, "energy": energy, "duration": duration}
        out = torch.func.functional_call(
            model, params, (text, src_lens, self.max_target_len),
            dict(control=ctrl, speaker_id=speaker_id, language_id=language_id,
                 pfs=text if model.uses_pfs else None))
        return out[self.mel_key], out["tgt_lens"], out["duration_rounded"]


class _Vocoder(torch.nn.Module):
    """The unfused f32 HiFiGAN generator as a function of its weights."""

    def __init__(self, config):
        super().__init__()
        self.config = config

    def forward(self, params, mel):
        from ..models.hifigan import hifigan_generator

        return hifigan_generator(params, mel, self.config)


def _program_bytes(module, args) -> bytes:
    """torch.export of `module` on `args`, saved without its example inputs
    (which would store a copy of the weights in every program)."""
    ep = torch.export.export(module, args)
    ep._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _state_bytes(state: Dict[str, torch.Tensor]) -> bytes:
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in state.items()}, buf)
    return buf.getvalue()


def export_serving_artifact(
    ckpt_path,
    out_path,
    vocoder_path=None,
    batch_sizes: Sequence[int] = (1, 8),
    text_buckets: Optional[Sequence[int]] = None,
    max_frames: Optional[int] = None,
    platforms=None,
    use_ema: bool = False,
    streaming_windows: Sequence[int] = (128,),
    device=None,
) -> Path:
    """Trace the serving program set with ``torch.export`` for each platform
    and write one ``.fs2x`` zip. `ckpt_path` is a reference-layout ``.ckpt``
    or a trainer's ``step=N/``; the export runs on `device` (the card by
    default, the CPU only by name), and `platforms` defaults to its type.
    Exporting for ``cuda`` needs the card."""
    from ..checkpoint import load_model_from_checkpoint

    device = resolve_device(device)
    plats = parse_platforms(platforms) or [device.type]
    devices = {p: resolve_device(p) for p in plats}
    model, config, stats, lang2id, speaker2id, step = load_model_from_checkpoint(
        Path(ckpt_path), device=device, use_ema=use_ema)
    cap = int(max_frames or config.model.max_mel_length)
    if text_buckets is None:
        text_buckets = default_text_buckets(config, stats)
    text_buckets = sorted({int(b) for b in text_buckets})
    batch_sizes = sorted({int(b) for b in batch_sizes})
    mel_key = "postnet_output" if config.model.use_postnet else "output"

    # (B, L) -> the frame estimate; the largest L also gets the cap, the
    # target of the duration-overflow re-run
    shapes = []
    for B in batch_sizes:
        for L in text_buckets:
            shapes.append((B, L, _frame_bucket(L, cap)))
        if _frame_bucket(text_buckets[-1], cap) < cap:
            shapes.append((B, text_buckets[-1], cap))

    voc_params = voc_cfg = voc_meta = None
    if vocoder_path is not None:
        from ..models.hifigan import load_vocoder_params

        voc_params, voc_cfg, _ = load_vocoder_params(Path(vocoder_path))
        voc_meta = {"sampling_rate": voc_cfg.sampling_rate, "hop": voc_cfg.total_upsampling,
                    "margin": voc_cfg.receptive_margin_frames}

    blobs: Dict[str, bytes] = {}
    acoustic = [{"B": B, "L": L, "T": T, "files": {}} for B, L, T in shapes]
    frame_buckets = sorted({T for _, _, T in shapes})
    vocoder = [{"B": B, "T": T, "files": {}} for B in batch_sizes for T in frame_buckets]
    streaming = []
    if voc_params is not None:
        margin = voc_cfg.receptive_margin_frames
        streaming = [{"window": w, "W": w + 2 * margin, "files": {}}
                     for w in sorted({int(w) for w in streaming_windows})]
    for plat, dev in devices.items():
        model = model.to(dev)
        params = dict(model.state_dict())
        i64 = dict(dtype=torch.int64, device=dev)
        scalar = torch.ones((), dtype=torch.float32, device=dev)
        for e in acoustic:
            B, L, T = e["B"], e["L"], e["T"]
            text = (torch.zeros((B, L, N_PHONOLOGICAL_FEATURES), device=dev)
                    if model.uses_pfs else torch.ones((B, L), **i64))
            args = (params, text, torch.full((B,), L, **i64), torch.zeros((B,), **i64),
                    torch.zeros((B,), **i64), scalar, scalar, scalar)
            name = f"acoustic/B{B}_L{L}_T{T}.{plat}.pt2"
            blobs[name] = _program_bytes(_Acoustic(model, T, mel_key), args)
            e["files"][plat] = name
        if voc_params is None:
            continue
        vp = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
              for k, v in voc_params.items()}
        n_mels = voc_cfg.n_mels
        for e in vocoder:
            name = f"vocoder/B{e['B']}_T{e['T']}.{plat}.pt2"
            mel = torch.zeros((e["B"], e["T"], n_mels), device=dev)
            blobs[name] = _program_bytes(_Vocoder(voc_cfg), (vp, mel))
            e["files"][plat] = name
        for e in streaming:
            name = f"vocoder_streaming/W{e['window']}.{plat}.pt2"
            mel = torch.zeros((1, e["W"], n_mels), device=dev)
            blobs[name] = _program_bytes(_Vocoder(voc_cfg), (vp, mel))
            e["files"][plat] = name

    meta = {
        "format_version": FORMAT_VERSION,
        "platforms": plats,
        "config": config.to_dict(),
        "stats": dataclasses.asdict(stats) if stats else None,
        "lang2id": lang2id,
        "speaker2id": speaker2id,
        "mel_key": mel_key,
        "max_frames": cap,
        "hop": config.preprocessing.audio.fft_hop_size,
        "acoustic": acoustic,
        "vocoder": vocoder if voc_params is not None else [],
        "vocoder_streaming": streaming,
        "vocoder_meta": voc_meta,
        "global_step": int(step),
        "torch_version": torch.__version__,
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=1))
        zf.writestr("params.pt", _state_bytes(model.state_dict()))
        if voc_params is not None:
            zf.writestr("vocoder_params.pt",
                        _state_bytes({k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
                                      for k, v in voc_params.items()}))
        for name, blob in blobs.items():
            zf.writestr(name, blob)
    return out_path


class _VocoderHandle:
    """What the server reads of a vocoder: ``sample_rate`` and ``hop``."""

    def __init__(self, meta: dict):
        self.sample_rate = meta["sampling_rate"]
        self.hop = meta["hop"]


class ExportedSynthesizer:
    """Serve synthesis from a ``.fs2x`` artifact on `device` (the card by
    default, the CPU only by name): no model code, no checkpoint. Mirrors
    the JAX class: it picks the smallest covering program and pads the rows,
    micro-batches above the largest exported B, re-runs a duration overflow
    at the smallest exported T that covers it, and trims the vocoder output
    by the generator's upsampling."""

    def __init__(self, path, device=None):
        self._zip = zipfile.ZipFile(Path(path), "r")
        self.meta = json.loads(self._zip.read("meta.json"))
        if "jax_version" in self.meta or any(n.endswith(".jaxexp")
                                             for n in self._zip.namelist()):
            raise ValueError(
                f"{path} was exported by the JAX package (jax "
                f"{self.meta.get('jax_version', '?')}): its StableHLO programs are served by "
                "the JAX package (fs2t serve); export a PyTorch artifact with "
                "`python -m fastspeech2_lightning_tpu_torch export-serving`")
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact format {self.meta.get('format_version')!r}")
        self.device = resolve_device(device)
        self.platform = self.device.type
        if self.platform not in self.meta["platforms"]:
            raise ValueError(f"{path} holds no programs for {self.platform!r} (exported for "
                             f"{self.meta['platforms']}); re-export with --platforms "
                             f"{self.platform}")
        self.config = FastSpeech2Config.from_dict(self.meta["config"])
        self.stats = Stats.from_dict(self.meta["stats"]) if self.meta["stats"] else None
        self.lang2id = self.meta["lang2id"]
        self.speaker2id = self.meta["speaker2id"]
        self.text_processor = TextProcessor(self.config.text)
        self.is_pfs = (self.config.model.target_text_representation_level
                       == PHONOLOGICAL_FEATURES)
        self.params = self._state("params.pt")
        self.vocoder_params = self._state("vocoder_params.pt") if self.meta["vocoder"] else None
        self.vocoder = (_VocoderHandle(self.meta["vocoder_meta"])
                        if self.vocoder_params is not None else None)
        self._encode_cache: dict = {}
        self._programs: Dict[str, torch.nn.Module] = {}
        # the server calls from several threads, and zip reads share one
        # file handle: loading is serialized; running a program is not
        self._lock = threading.Lock()

    @property
    def global_step(self) -> int:
        return int(self.meta.get("global_step", 0))

    def _state(self, name: str) -> Dict[str, torch.Tensor]:
        state = torch.load(io.BytesIO(self._zip.read(name)), map_location="cpu",
                           weights_only=True)
        return {k: v.to(self.device) for k, v in state.items()}

    def _program(self, entry: dict) -> torch.nn.Module:
        name = entry["files"][self.platform]
        program = self._programs.get(name)
        if program is None:
            with self._lock:
                program = self._programs.get(name)
                if program is None:
                    ep = torch.export.load(io.BytesIO(self._zip.read(name)))
                    program = self._programs[name] = ep.module()
        return program

    def _run(self, entry: dict, *args):
        with torch.inference_mode():
            return self._program(entry)(*args)

    def _pick_acoustic(self, B: int, L: int, min_T: int = 0) -> dict:
        """The smallest covering (B', L', T') program."""
        fits = [e for e in self.meta["acoustic"]
                if e["B"] >= B and e["L"] >= L and e["T"] >= min_T]
        if not fits:
            raise ValueError(
                f"no exported acoustic program covers batch={B}, text_len={L}, "
                f"frames>={min_T} (exported: {[(e['B'], e['L'], e['T']) for e in self.meta['acoustic']]})")
        return min(fits, key=lambda e: (e["B"], e["L"], e["T"]))

    def _pick_vocoder(self, B: int, T: int) -> dict:
        fits = [e for e in self.meta["vocoder"] if e["B"] >= B and e["T"] >= T]
        if not fits:
            raise ValueError(f"no exported vocoder program covers batch={B}, frames={T}")
        return min(fits, key=lambda e: (e["B"], e["T"]))

    def _vocode(self, entry: dict, mel: torch.Tensor) -> torch.Tensor:
        """`mel` [b, t, n_mels] on the device through the vocoder program
        `entry`, zero-padded to its (B, T)."""
        mel = mel[:, : entry["T"]]
        b, t, n = mel.shape
        if (b, t) != (entry["B"], entry["T"]):
            padded = mel.new_zeros((entry["B"], entry["T"], n))
            padded[:b, :t] = mel
            mel = padded
        return self._run(entry, self.vocoder_params, mel)

    def synthesize(
        self,
        texts: List[str],
        language: Optional[str] = None,
        speaker: Optional[str] = None,
        pitch_control: float = 1.0,
        energy_control: float = 1.0,
        duration_control: float = 1.0,
        vocode: bool = True,
        style_reference=None,
    ) -> SynthesisResult:
        """The live ``Synthesizer.synthesize`` on the exported programs. A
        style reference is an input the programs do not take (the server
        passes its own, None for an artifact)."""
        if style_reference is not None:
            raise ValueError("a style reference cannot apply to a .fs2x artifact: its "
                             "programs are fixed at export time")
        # names are checked before encoding, as the live Synthesizer does
        if language is not None and language not in self.lang2id:
            raise ValueError(f"unknown language {language!r}; available: "
                             f"{sorted(self.lang2id) or ['<none>']}")
        if speaker is not None and speaker not in self.speaker2id:
            raise ValueError(f"unknown speaker {speaker!r}; available: "
                             f"{sorted(self.speaker2id) or ['<none>']}")
        encoded, pfs_mats = encode_texts_for_model(texts, language, self.config,
                                                   self.text_processor, self._encode_cache)
        if any(len(e) == 0 for e in encoded):
            raise ValueError("one or more inputs contain no known symbols")
        B = len(encoded)
        max_B = max(e["B"] for e in self.meta["acoustic"])
        if B > max_B:
            # micro-batch through the largest exported batch program
            parts = [self.synthesize(texts[i: i + max_B], language=language, speaker=speaker,
                                     pitch_control=pitch_control,
                                     energy_control=energy_control,
                                     duration_control=duration_control, vocode=vocode)
                     for i in range(0, B, max_B)]
            return SynthesisResult(
                mels=[m for p in parts for m in p.mels],
                durations=[d for p in parts for d in p.durations],
                wavs=[w for p in parts for w in p.wavs] if parts[0].wavs is not None else None,
                sample_rate=parts[0].sample_rate)
        L = _round_up(max(len(e) for e in encoded), PAD_MULT_TEXT)
        lang_id = self.lang2id.get(language or "", 0) if language else 0
        spk_id = self.speaker2id.get(speaker or "", 0) if speaker else 0
        dev = self.device

        def run(entry):
            eB, eL = entry["B"], entry["L"]
            lens = np.ones(eB, dtype=np.int64)  # pad rows: 1 token
            if self.is_pfs:
                text = np.zeros((eB, eL, N_PHONOLOGICAL_FEATURES), dtype=np.float32)
                for i, m in enumerate(pfs_mats):
                    text[i, : min(len(m), eL)] = m[:eL]
            else:
                text = np.zeros((eB, eL), dtype=np.int64)
                for i, e in enumerate(encoded):
                    text[i, : len(e)] = e[:eL]
            lens[:B] = [len(e) for e in encoded]
            return self._run(
                entry, self.params, torch.as_tensor(text, device=dev),
                torch.as_tensor(lens, device=dev),
                torch.full((eB,), spk_id, dtype=torch.int64, device=dev),
                torch.full((eB,), lang_id, dtype=torch.int64, device=dev),
                *(torch.tensor(float(c), dtype=torch.float32, device=dev)
                  for c in (pitch_control, energy_control, duration_control)))

        entry = self._pick_acoustic(B, L)
        mel_dev, tgt_lens, dur = run(entry)
        dur = dur.cpu().numpy()
        true_total = int(dur[:B].sum(axis=1).max())
        if true_total > entry["T"]:
            # duration overflow: the smallest exported program whose frame
            # budget covers it (the cap at most)
            bigger = self._pick_acoustic(B, L, min_T=min(true_total, self.meta["max_frames"]))
            if bigger["T"] > entry["T"]:
                entry = bigger
                mel_dev, tgt_lens, dur = run(entry)
                dur = dur.cpu().numpy()
        lens = tgt_lens.cpu().numpy()

        wav_dev = None
        if vocode and self.vocoder_params is not None:
            t_need = min(_round_up(max(int(lens[:B].max()), 1), 128), entry["T"])
            wav_dev = self._vocode(self._pick_vocoder(entry["B"], t_need), mel_dev)
        mels_padded = mel_dev.cpu().numpy()
        mels = [mels_padded[i, : lens[i]] for i in range(B)]
        durations = [dur[i, : len(encoded[i])] for i in range(B)]
        wavs = sr = None
        if wav_dev is not None:
            sr = self.vocoder.sample_rate
            # samples per mel frame: the generator's upsampling
            hop = int(self.vocoder.hop)
            wav_host = wav_dev.float().cpu().numpy()
            wavs = [wav_host[i, : lens[i] * hop] for i in range(B)]
        return SynthesisResult(mels=mels, durations=durations, wavs=wavs, sample_rate=sr)

    def _chunk_long_text(self, text: str, language=None) -> List[str]:
        return chunk_text_for_model(text, language, self.config, self.stats)

    def synthesize_long(self, text: str, **kwargs) -> SynthesisResult:
        """Chunk at the corpus-informed boundaries, synthesize the chunks as
        one batch, and reassemble one utterance."""
        chunks = self._chunk_long_text(text, kwargs.get("language"))
        result = self.synthesize(chunks, **kwargs)
        mel = np.concatenate(result.mels, axis=0)
        durations = np.concatenate(result.durations)
        wavs = [np.concatenate(result.wavs)] if result.wavs is not None else None
        return SynthesisResult(mels=[mel], durations=[durations], wavs=wavs,
                               sample_rate=result.sample_rate)

    def synthesize_stream(self, text: str, window: int = 128, margin: Optional[int] = None,
                          **kwargs):
        """Yield float32 wav segments from the exported window programs
        (``Synthesizer.synthesize_stream`` semantics): each window of a mel
        longer than the program's slice carries the generator's receptive
        field, so the pieces put together equal vocoding the whole mel; a
        shorter mel goes through the bucketed vocoder program."""
        if self.vocoder_params is None:
            raise ValueError("synthesize_stream requires exported vocoder programs "
                             "(export-serving -v ...)")
        entries = {e["window"]: e for e in self.meta.get("vocoder_streaming", [])}
        if window not in entries:
            raise ValueError(f"window {window} was not exported; available: "
                             f"{sorted(entries) or ['<none>']} (re-export with "
                             "--streaming-window)")
        m = self.meta["vocoder_meta"]["margin"]
        if margin is not None and margin != m:
            raise ValueError("margin is fixed at export time to the generator's exact "
                             f"receptive field ({m})")
        entry = entries[window]
        hop = self.vocoder.hop
        W = entry["W"]
        kwargs.pop("vocode", None)
        chunks = self._chunk_long_text(text, kwargs.get("language"))
        result = self.synthesize(chunks, vocode=False, **kwargs)
        for mel in result.mels:
            T = mel.shape[0]
            mel_t = torch.as_tensor(mel, device=self.device)
            if T <= W:
                # too short to window: the mel already computed through the
                # bucketed program, padded to its shape
                wav = self._vocode(self._pick_vocoder(1, max(T, 1)), mel_t[None])[0]
                yield wav.cpu().numpy()[: T * hop]
                continue
            for start in range(0, T, window):
                end = min(start + window, T)
                lo = min(max(start - m, 0), T - W)
                wav = self._run(entry, self.vocoder_params, mel_t[None, lo: lo + W])[0]
                yield wav.cpu().numpy()[(start - lo) * hop: (end - lo) * hop]

    def warmup(self, batch_size: int = 0) -> int:
        """Load and run every exported program once; returns the count.
        `batch_size` is ignored: the program set is fixed at export time."""
        dev = self.device
        one = torch.ones((), dtype=torch.float32, device=dev)
        n = 0
        for e in self.meta["acoustic"]:
            B, L = e["B"], e["L"]
            text = (torch.zeros((B, L, N_PHONOLOGICAL_FEATURES), device=dev) if self.is_pfs
                    else torch.ones((B, L), dtype=torch.int64, device=dev))
            ids = torch.zeros((B,), dtype=torch.int64, device=dev)
            self._run(e, self.params, text, torch.full((B,), L, dtype=torch.int64, device=dev),
                      ids, ids, one, one, one)
            n += 1
        n_mels = self.config.preprocessing.audio.n_mels
        for e in self.meta["vocoder"]:
            self._run(e, self.vocoder_params, torch.zeros((e["B"], e["T"], n_mels), device=dev))
            n += 1
        for e in self.meta.get("vocoder_streaming", []):
            self._run(e, self.vocoder_params, torch.zeros((1, e["W"], n_mels), device=dev))
            n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return n

    def close(self) -> None:
        self._zip.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
