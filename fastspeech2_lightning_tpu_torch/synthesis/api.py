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
128-multiple of the longest utterance, without leaving the device."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint import load_model_from_checkpoint
from ..dataset import PAD_MULT_TEXT, _round_up
from ..text import TextProcessor
from .prepare import chunk_text_for_model, encode_texts_for_model


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
    ) -> "Synthesizer":
        """Load a reference-layout ``.ckpt`` (and a HiFiGAN ``.npz``/``.ckpt``)
        onto `device`: the current CUDA card by default, the CPU only when
        asked for by name. vocoder_fused routes the vocoder's low-channel
        resblock stages through the MRF kernel."""
        if data_parallel is not None and data_parallel > 1:
            raise NotImplementedError(
                "data-parallel serving is not ported yet (later slice: data parallel)"
            )
        if vocoder_path is not None and str(vocoder_path).lower() in (
            "griffin-lim", "griffin_lim", "griffinlim"
        ):
            raise NotImplementedError(
                "the Griffin-Lim vocoder is not ported yet (later slice: synthesize writers)"
            )
        model, config, stats, lang2id, speaker2id, step = load_model_from_checkpoint(
            Path(ckpt_path), device=device
        )
        vocoder = None
        if vocoder_path is not None:
            from ..models.hifigan import load_vocoder_params, make_vocoder_fn

            vp, vcfg, _ = load_vocoder_params(Path(vocoder_path))
            vocoder = make_vocoder_fn(
                vp, vcfg, precision=vocoder_precision, fused=vocoder_fused,
                device=next(model.parameters()).device,
            )
        return cls(model, config, stats, lang2id, speaker2id, vocoder=vocoder,
                   max_frames=max_frames, global_step=step)

    def _forward(self, text, src_lens, spk, lang, ctrl, max_len: int):
        return self.model(text, src_lens, max_len, control=ctrl, speaker_id=spk,
                          language_id=lang)

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
        if style_reference is not None:
            raise NotImplementedError(
                "style references need the global-style-token module, which is "
                "not ported yet (later slice: GST)"
            )
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
        encoded = encode_texts_for_model(texts, self.config, self.text_processor)
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
        ctrl = {"pitch": float(pitch_control), "energy": float(energy_control),
                "duration": float(duration_control)}

        cap = int(self.max_frames)
        # ~12 frames/symbol upper estimate; the duration total corrects misses
        est = min(cap, _round_up(12 * L, 128)) if adaptive_max_frames else cap
        out = self._forward(text_t, src_lens, spk, lang, ctrl, est)
        dur = out["duration_rounded"].cpu().numpy()
        true_total = int(dur.sum(axis=1).max())
        if est < cap and true_total > est:
            need = min(cap, _round_up(max(true_total, 1), 128))
            out = self._forward(text_t, src_lens, spk, lang, ctrl, need)
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
        self._forward(text, lens, ids, ids, None, min(int(self.max_frames), 128))
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
