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
global style tokens."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint import load_model_from_checkpoint
from ..dataset import PAD_MULT_TEXT, _round_up
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
                 vocoder=None, max_frames: Optional[int] = None, global_step: int = 0):
        self.model = model
        self.global_step = global_step
        self.config = config
        self.stats = stats
        self.lang2id = lang2id
        self.speaker2id = speaker2id
        self.vocoder = vocoder
        self.device = next(model.parameters()).device
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
    ) -> "Synthesizer":
        """Load a reference-layout ``.ckpt`` or a trainer's ``step=N/`` (and a
        HiFiGAN ``.npz``/``.ckpt``, or Griffin-Lim for ``"griffin-lim"``)
        onto `device`: the current CUDA card by default, the CPU only when
        asked for by name. vocoder_fused routes
        the vocoder's low-channel resblock stages through the MRF kernel;
        use_ema takes a ``step=N/``'s EMA weights (a ``.ckpt`` has none:
        ValueError)."""
        if data_parallel is not None and data_parallel > 1:
            raise NotImplementedError(
                "data-parallel serving is not ported yet (later slice: data parallel)"
            )
        model, config, stats, lang2id, speaker2id, step = load_model_from_checkpoint(
            Path(ckpt_path), device=device, use_ema=use_ema
        )
        vocoder = None
        if vocoder_path is not None and is_griffin_lim_path(vocoder_path):
            vocoder = GriffinLimVocoder(config.preprocessing.audio,
                                        device=next(model.parameters()).device)
        elif vocoder_path is not None:
            from ..models.hifigan import load_vocoder_params, make_vocoder_fn

            vp, vcfg, _ = load_vocoder_params(Path(vocoder_path))
            vocoder = make_vocoder_fn(
                vp, vcfg, precision=vocoder_precision, fused=vocoder_fused,
                device=next(model.parameters()).device,
            )
        return cls(model, config, stats, lang2id, speaker2id, vocoder=vocoder,
                   max_frames=max_frames, global_step=step)

    def _forward(self, text, src_lens, spk, lang, ctrl, max_len: int, pfs=None, style=None):
        return self.model(text, src_lens, max_len, control=ctrl, speaker_id=spk,
                          language_id=lang, pfs=pfs, mel_style_reference=style)

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
        dev = self.device
        text_t = torch.as_tensor(text, device=dev)
        src_lens = torch.as_tensor([len(e) for e in encoded], dtype=torch.int64, device=dev)
        spk = torch.full((B,), spk_id, dtype=torch.int64, device=dev)
        lang = torch.full((B,), lang_id, dtype=torch.int64, device=dev)
        pfs = style = None
        if pfs_mats is not None:
            pfs_np = np.zeros((B, L, pfs_mats[0].shape[1]), dtype=np.float32)
            for i, m in enumerate(pfs_mats):
                pfs_np[i, : min(len(m), L)] = m[:L]
            pfs = torch.as_tensor(pfs_np, device=dev)
        if style_reference is not None:
            if not self.config.model.use_global_style_token_module:
                raise ValueError("style_reference requires a model trained with "
                                 "model.use_global_style_token_module")
            ref = torch.as_tensor(self._style_reference_mel(style_reference), device=dev)
            style = ref[None].expand(B, -1, -1)
        ctrl = {"pitch": float(pitch_control), "energy": float(energy_control),
                "duration": float(duration_control)}

        cap = int(self.max_frames)
        # ~12 frames/symbol upper estimate; the duration total corrects misses
        est = min(cap, _round_up(12 * L, 128)) if adaptive_max_frames else cap
        out = self._forward(text_t, src_lens, spk, lang, ctrl, est, pfs, style)
        dur = out["duration_rounded"].cpu().numpy()
        true_total = int(dur.sum(axis=1).max())
        if est < cap and true_total > est:
            need = min(cap, _round_up(max(true_total, 1), 128))
            out = self._forward(text_t, src_lens, spk, lang, ctrl, need, pfs, style)
            dur = out["duration_rounded"].cpu().numpy()
        lens = out["tgt_lens"].cpu().numpy()
        key = "postnet_output" if self.config.model.use_postnet else "output"

        wav_dev = None
        if self.vocoder is not None and vocode:
            # the vocoder's cost scales with T: trim the padded mels to a
            # 128-multiple of the longest utterance before vocoding
            t_need = min(_round_up(max(int(lens.max()), 1), 128), out[key].shape[1])
            wav_dev = self.vocoder.device_fn(out[key][:, :t_need])

        mels_padded = out[key].cpu().numpy()
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
        vocoder call at 128 frames. PyTorch compiles nothing per shape, so no
        bucket sweep is needed. Returns the number of calls made."""
        text = torch.ones((batch_size, PAD_MULT_TEXT), dtype=torch.int64, device=self.device)
        lens = torch.full((batch_size,), PAD_MULT_TEXT, dtype=torch.int64, device=self.device)
        ids = torch.zeros((batch_size,), dtype=torch.int64, device=self.device)
        pfs = None
        if self.model.uses_pfs:
            from ..text.features import N_PHONOLOGICAL_FEATURES

            pfs = torch.zeros((batch_size, PAD_MULT_TEXT, N_PHONOLOGICAL_FEATURES),
                              device=self.device)
        self._forward(text, lens, ids, ids, None, min(int(self.max_frames), 128), pfs)
        n = 1
        if self.vocoder is not None:
            mel = torch.zeros((batch_size, 128, self.config.preprocessing.audio.n_mels),
                              device=self.device)
            self.vocoder.device_fn(mel)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
