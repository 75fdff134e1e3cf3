"""Resident synthesis API (counterpart of the JAX package's
``synthesis/api.py``): load a checkpoint and a vocoder once, then text ->
(mel, durations, wav).

    synth = Synthesizer.from_checkpoint("model.ckpt", vocoder_path="hifigan.npz")
    result = synth.synthesize(["hello world", "how are you"])
    result.mels[0]      # [T0, n_mels]
    result.wavs[0]      # [T0 * hop] float32 (when a vocoder is loaded)

Text is padded to a multiple of 16 symbols. The forward runs at an adaptive
frame bucket min(cap, round_up(12 * L, 128)); the predicted durations give
the true total, and an underestimate is re-run at the exact bucket, so the
output equals the fixed-cap path. Mels go to the vocoder trimmed to a
128-multiple of the longest utterance, without leaving the device.
``synthesize_stream`` yields a long text's audio window by window
(``streaming.windowed_vocode``) after one acoustic forward; a style
reference (a wav path or a [T, n_mels] log-mel) conditions a model with
global style tokens.

Data parallel (``data_parallel=N`` or ``devices=[...]``, the JAX package's
``mesh``): one model replica a device in this process
(``parallel.replicas``). A batch's rows are padded to a multiple of N with
copies of row 0 and split into N contiguous blocks, each run by its replica
on its own thread; every block keeps the whole batch's text padding and
frame bucket, and a re-run at the exact bucket runs every replica again, as
JAX re-runs the whole padded batch. The vocoder is
``make_parallel_vocoder_fn`` over the same replicas, told how many rows are
real, so a long request alone is vocoded in windows across the devices. The
fill rows are sliced off before anything is returned."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint import load_model_from_checkpoint
from ..dataset import PAD_MULT_TEXT, _round_up
from ..parallel.replicas import (
    Replicas,
    concat_rows,
    fill_count,
    make_replicas,
    pad_rows,
    replica_devices,
    split_batch,
    to_caller,
)
from ..text import TextProcessor
from .griffin_lim import GriffinLimVocoder, is_griffin_lim_path
from .prepare import chunk_text_for_model, encode_texts_for_model, style_reference_mel


@dataclasses.dataclass
class SynthesisResult:
    mels: List[np.ndarray]  # per-utterance [T_i, n_mels]
    durations: List[np.ndarray]  # per-utterance [L_i] frames
    wavs: Optional[List[np.ndarray]]  # per-utterance samples (if vocoder)
    sample_rate: Optional[int]


class Synthesizer:
    def __init__(self, model, config, stats, lang2id: dict, speaker2id: dict,
                 vocoder=None, max_frames: Optional[int] = None, global_step: int = 0,
                 devices=None, replicas: Optional[Replicas] = None):
        """`devices`: one model replica each (``parallel.replicas``); by
        default the model's own device alone. `replicas` runs them (made
        for `devices` if None; ``from_checkpoint`` shares its own with the
        parallel vocoder)."""
        self.model = model
        self.global_step = global_step
        self.config = config
        self.stats = stats
        self.lang2id = lang2id
        self.speaker2id = speaker2id
        self.vocoder = vocoder
        self.devices = (replica_devices(devices) if devices is not None
                        else [next(model.parameters()).device])
        self.device = self.devices[0]
        self.replicas = replicas or Replicas(self.devices)
        self._models = make_replicas(model, self.devices)
        self.text_processor = TextProcessor(config.text)
        self.max_frames = max_frames or config.model.max_mel_length
        self._encode_cache: dict = {}
        self._style_cache: dict = {}

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_path,
        vocoder_path=None,
        max_frames: Optional[int] = None,
        vocoder_precision: str = "float32",
        vocoder_fused: bool = False,
        data_parallel: Optional[int] = None,
        device=None,
        use_ema: bool = False,
        devices=None,
    ) -> "Synthesizer":
        """Load a reference-layout ``.ckpt`` or a trainer's ``step=N/`` (and a
        HiFiGAN ``.npz``/``.ckpt``, or Griffin-Lim for ``"griffin-lim"``)
        onto `device`: the current CUDA card by default, the CPU only when
        asked for by name. vocoder_fused routes
        the vocoder's low-channel resblock stages through the MRF kernel;
        use_ema takes a ``step=N/``'s EMA weights (a ``.ckpt`` has none:
        ValueError). data_parallel=N (or `devices`, a list) serves from one
        replica a device: N CPU replicas with device="cpu", else cuda:0 ..
        cuda:N-1 (more than ``torch.cuda.device_count()``: ValueError)."""
        devices = replica_devices(devices, data_parallel, device)
        model, config, stats, lang2id, speaker2id, step = load_model_from_checkpoint(
            Path(ckpt_path), device=devices[0], use_ema=use_ema
        )
        replicas = Replicas(devices)
        vocoder = None
        if vocoder_path is not None and is_griffin_lim_path(vocoder_path):
            vocoder = GriffinLimVocoder(config.preprocessing.audio, device=devices[0])
        elif vocoder_path is not None:
            from ..models.hifigan import (
                load_vocoder_params,
                make_parallel_vocoder_fn,
                make_vocoder_fn,
            )

            vp, vcfg, _ = load_vocoder_params(Path(vocoder_path))
            if len(devices) > 1:
                vocoder = make_parallel_vocoder_fn(vp, vcfg, devices,
                                                   precision=vocoder_precision,
                                                   fused=vocoder_fused, replicas=replicas)
            else:
                vocoder = make_vocoder_fn(vp, vcfg, precision=vocoder_precision,
                                          fused=vocoder_fused, device=devices[0])
        return cls(model, config, stats, lang2id, speaker2id, vocoder=vocoder,
                   max_frames=max_frames, global_step=step, devices=devices,
                   replicas=replicas)

    def _forward(self, text, src_lens, spk, lang, ctrl, max_len: int, pfs=None, style=None,
                 replica: int = 0):
        return self._models[replica](text, src_lens, max_len, control=ctrl, speaker_id=spk,
                                     language_id=lang, pfs=pfs, mel_style_reference=style)

    def _forward_rows(self, i: int, rows: dict, style_ref, ctrl, max_len: int):
        """Replica i's forward on its block of rows (host arrays, moved to
        its device here): (outputs on the device, durations and lengths on
        the host)."""
        dev = self.devices[i]
        t = {k: torch.as_tensor(v, device=dev) for k, v in rows.items()}
        style = None
        if style_ref is not None:
            style = torch.as_tensor(style_ref, device=dev)[None].expand(len(rows["text"]), -1, -1)
        out = self._forward(t["text"], t["src_lens"], t["speaker"], t["language"], ctrl,
                            max_len, t.get("pfs"), style, replica=i)
        return out, out["duration_rounded"].cpu().numpy(), out["tgt_lens"].cpu().numpy()

    def _run(self, blocks: list, style_ref, ctrl, max_len: int):
        """Every replica's forward on its block at `max_len` frames; (the
        outputs a replica, durations and lengths of all rows)."""
        res = self.replicas.map(self._forward_rows, blocks, [style_ref] * len(blocks),
                                [ctrl] * len(blocks), [max_len] * len(blocks))
        return ([r[0] for r in res], concat_rows([r[1] for r in res]),
                concat_rows([r[2] for r in res]))

    def _style_reference_mel(self, style_reference) -> np.ndarray:
        """[T_ref, n_mels] log-mel of a style-reference wav path (cached per
        path) or of a given array; not padded, since the style encoder's
        convolutions and GRU see the length (``api.py:147-171``)."""
        if isinstance(style_reference, np.ndarray):
            return style_reference.astype(np.float32)
        key = str(style_reference)
        if key not in self._style_cache:
            self._style_cache[key] = style_reference_mel(Path(style_reference),
                                                         self.config.preprocessing.audio)
        return self._style_cache[key]

    @torch.inference_mode()
    def synthesize(
        self,
        texts: List[str],
        language: Optional[str] = None,
        speaker: Optional[str] = None,
        pitch_control: float = 1.0,
        energy_control: float = 1.0,
        duration_control: float = 1.0,
        adaptive_max_frames: bool = True,
        vocode: bool = True,
        style_reference=None,
    ) -> SynthesisResult:
        if language is not None and language not in self.lang2id:
            raise ValueError(
                f"unknown language {language!r}; available: "
                f"{sorted(self.lang2id) or ['<none>']}"
            )
        if speaker is not None and speaker not in self.speaker2id:
            raise ValueError(
                f"unknown speaker {speaker!r}; available: "
                f"{sorted(self.speaker2id) or ['<none>']}"
            )
        encoded, pfs_mats = encode_texts_for_model(texts, language, self.config,
                                                   self.text_processor, self._encode_cache)
        if any(len(e) == 0 for e in encoded):
            raise ValueError("one or more inputs contain no known symbols")
        B = len(encoded)
        L = _round_up(max(len(e) for e in encoded), PAD_MULT_TEXT)
        text = np.zeros((B, L), dtype=np.int64)
        for i, e in enumerate(encoded):
            text[i, : len(e)] = e[:L]
        lang_id = self.lang2id.get(language or "", 0) if language else 0
        spk_id = self.speaker2id.get(speaker or "", 0) if speaker else 0
        rows = {"text": text,
                "src_lens": np.asarray([len(e) for e in encoded], dtype=np.int64),
                "speaker": np.full((B,), spk_id, dtype=np.int64),
                "language": np.full((B,), lang_id, dtype=np.int64)}
        if pfs_mats is not None:
            pfs_np = np.zeros((B, L, pfs_mats[0].shape[1]), dtype=np.float32)
            for i, m in enumerate(pfs_mats):
                pfs_np[i, : min(len(m), L)] = m[:L]
            rows["pfs"] = pfs_np
        style_ref = None
        if style_reference is not None:
            if not self.config.model.use_global_style_token_module:
                raise ValueError("style_reference requires a model trained with "
                                 "model.use_global_style_token_module")
            style_ref = self._style_reference_mel(style_reference)
        ctrl = {"pitch": float(pitch_control), "energy": float(energy_control),
                "duration": float(duration_control)}
        # data parallel: row-0 fill to a multiple of the replicas, sliced off below
        n_rep = len(self.devices)
        fill = fill_count(B, n_rep)
        blocks = split_batch({k: pad_rows(v, fill) for k, v in rows.items()}, n_rep, B + fill)

        cap = int(self.max_frames)
        # ~12 frames/symbol upper estimate; the duration total corrects misses
        est = min(cap, _round_up(12 * L, 128)) if adaptive_max_frames else cap
        outs, dur, lens = self._run(blocks, style_ref, ctrl, est)
        true_total = int(dur.sum(axis=1).max())
        if est < cap and true_total > est:
            need = min(cap, _round_up(max(true_total, 1), 128))
            outs, dur, lens = self._run(blocks, style_ref, ctrl, need)
        key = "postnet_output" if self.config.model.use_postnet else "output"

        wav_dev = None
        if self.vocoder is not None and vocode:
            # the vocoder's cost scales with T: trim the padded mels to a
            # 128-multiple of the longest utterance before vocoding
            t_need = min(_round_up(max(int(lens.max()), 1), 128), outs[0][key].shape[1])
            mel_blocks = [o[key][:, :t_need] for o in outs]
            if n_rep == 1:
                wav_dev = self.vocoder.device_fn(mel_blocks[0])
            elif hasattr(self.vocoder, "_window_cache"):
                wav_dev = self.vocoder.device_fn(mel_blocks, n_real=B)
            else:  # a vocoder of one device (Griffin-Lim): on the first
                wav_dev = self.vocoder.device_fn(
                    concat_rows([to_caller(m, self.device) for m in mel_blocks])[:B])

        mels_padded = concat_rows([o[key].cpu().numpy() for o in outs])
        mels = [mels_padded[i, : lens[i]] for i in range(B)]
        durations = [dur[i, : len(encoded[i])] for i in range(B)]
        wavs = sr = None
        if wav_dev is not None:
            sr = self.vocoder.sample_rate
            # samples per mel frame = the generator's total upsampling
            hop = int(self.vocoder.hop)
            wav_host = wav_dev.float().cpu().numpy()
            wavs = [wav_host[i, : lens[i] * hop] for i in range(B)]
        return SynthesisResult(mels=mels, durations=durations, wavs=wavs, sample_rate=sr)

    def warmup(self, batch_size: int) -> int:
        """Build the kernels and initialise the device libraries before the
        first request: one forward at the smallest text bucket and one
        vocoder call at 128 frames, on every replica, at `batch_size` rows
        rounded up to a multiple of the replicas (the rows requests run
        at). PyTorch compiles nothing per shape, so no bucket sweep is
        needed. Returns the number of calls made."""
        n_rep = len(self.devices)
        eff = _round_up(batch_size, n_rep)
        rows = {"text": np.ones((eff, PAD_MULT_TEXT), dtype=np.int64),
                "src_lens": np.full((eff,), PAD_MULT_TEXT, dtype=np.int64),
                "speaker": np.zeros((eff,), dtype=np.int64),
                "language": np.zeros((eff,), dtype=np.int64)}
        if self.model.uses_pfs:
            from ..text.features import N_PHONOLOGICAL_FEATURES

            rows["pfs"] = np.zeros((eff, PAD_MULT_TEXT, N_PHONOLOGICAL_FEATURES), np.float32)
        self._run(split_batch(rows, n_rep, eff), None, None, min(int(self.max_frames), 128))
        n = 1
        if self.vocoder is not None:
            n_mels = self.config.preprocessing.audio.n_mels
            if n_rep > 1 and hasattr(self.vocoder, "_window_cache"):
                self.vocoder.device_fn([torch.zeros((eff // n_rep, 128, n_mels), device=d)
                                        for d in self.devices], n_real=batch_size)
            else:
                self.vocoder.device_fn(torch.zeros((eff, 128, n_mels), device=self.device))
            n += 1
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return n

    def _chunk_text(self, text: str, language: Optional[str]) -> List[str]:
        return chunk_text_for_model(text, language, self.config, self.stats)

    def synthesize_stream(self, text: str, window: int = 128, margin: Optional[int] = None,
                          **kwargs):
        """Yield a long text's float32 audio in pieces as they are vocoded
        (``api.py:437-462``): one acoustic forward over all its chunks, then
        each chunk's mel through the vocoder in windows of `window` frames
        with `margin` frames of context (``streaming.windowed_vocode``);
        the pieces put together equal vocoding each mel whole."""
        if self.vocoder is None:
            raise ValueError("synthesize_stream requires a loaded vocoder")
        from .streaming import windowed_vocode

        chunks = self._chunk_text(text, kwargs.get("language"))
        result = self.synthesize(chunks, vocode=False, **kwargs)
        for mel in result.mels:
            yield from windowed_vocode(self.vocoder, mel, window=window, margin=margin)

    def synthesize_long(self, text: str, **kwargs) -> SynthesisResult:
        """Chunk at the corpus-informed boundaries, synthesize the chunks as
        one batch, and reassemble a single utterance."""
        chunks = self._chunk_text(text, kwargs.get("language"))
        result = self.synthesize(chunks, **kwargs)
        mel = np.concatenate(result.mels, axis=0)
        durations = np.concatenate(result.durations)
        wavs = [np.concatenate(result.wavs)] if result.wavs is not None else None
        return SynthesisResult(mels=[mel], durations=[durations], wavs=wavs,
                               sample_rate=result.sample_rate)
