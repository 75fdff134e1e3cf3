"""Prediction writers: wav, spec, TextGrid and ReadAlong outputs (the
counterpart of the JAX package's ``synthesis/writers.py``).

The same factory (``get_synthesis_output_writers``, with ``check-data``'s
``ScorerWriter``), the same file names
``{basename}--{speaker}--{language}[--ckpt=N][--v_ckpt=N]--{extension}``
and the same serializers, and the same reassembly of chunked utterances
across batches, keyed on ``is_last_input_chunk``. Writers are host objects
that take the numpy outputs of a batch; the chunk accumulators live here."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import FastSpeech2Config
from ..preprocessing.pipeline import save_wav
from ..text import TextProcessor
from ..text.processor import PAD_SYMBOL
from ..type_definitions import SynthesizeOutputFormats
from ..utils import slugify, truncate_basename, write_filelist

SEP = "--"


class PredictionWriterBase:
    def __init__(
        self,
        config: FastSpeech2Config,
        file_extension: str,
        global_step: int,
        save_dir: Path,
        include_global_step_in_filename: bool = False,
    ):
        self.config = config
        self.file_extension = file_extension
        self.global_step = global_step
        self.save_dir = Path(save_dir)
        self.include_global_step_in_filename = include_global_step_in_filename
        self.sep = SEP
        self.save_dir.mkdir(parents=True, exist_ok=True)

    def get_filename(self, basename: str, speaker: str, language: str) -> str:
        parts = [truncate_basename(basename), speaker, language]
        if self.include_global_step_in_filename:
            parts.append(f"ckpt={self.global_step}")
        parts.append(self.file_extension)
        return str(self.save_dir / self.sep.join(parts))

    def on_predict_batch_end(self, outputs: Dict[str, Any], batch: Dict[str, Any]):
        raise NotImplementedError


class PredictionWritingSpecWriter(PredictionWriterBase):
    """Chunk-reassembled [K, T] mel saved as .npy; consumable by the
    spec-to-wav fine-tuning path."""

    def __init__(self, config, global_step, output_dir: Path, output_key: str):
        a = config.preprocessing.audio
        super().__init__(
            config=config,
            file_extension=f"spec-pred-{a.input_sampling_rate}-{a.spec_type}.npy",
            global_step=global_step,
            save_dir=Path(output_dir) / "synthesized_spec",
        )
        self.output_key = output_key
        self.full_text = ""
        self.full_spec: Optional[np.ndarray] = None
        self.last_file_written: Optional[str] = None

    def on_predict_batch_end(self, outputs, batch):
        lens = np.asarray(outputs["tgt_lens"])
        for i, data in enumerate(np.asarray(outputs[self.output_key])):
            spec = data[: lens[i]].T  # [K, T]
            self.full_spec = (
                spec
                if self.full_spec is None
                else np.concatenate([self.full_spec, spec], axis=-1)
            )
            self.full_text += batch["raw_text"][i]
            if batch["is_last_input_chunk"][i]:
                basename = slugify(self.full_text)
                filename = self.get_filename(
                    basename, batch["speaker"][i], batch["language"][i]
                )
                np.save(filename, self.full_spec)
                self.last_file_written = filename + (
                    "" if filename.endswith(".npy") else ".npy"
                )
                self.full_spec = None
                self.full_text = ""


class PredictionWritingAlignedTextWriter(PredictionWriterBase):
    """Base: predicted log-durations -> frame -> second intervals, phone and
    word tiers, accumulated across chunks with running offsets."""

    def __init__(self, config, global_step, output_key, file_extension, save_dir):
        super().__init__(
            config=config,
            global_step=global_step,
            file_extension=file_extension,
            save_dir=save_dir,
        )
        self.output_key = output_key
        self.text_processor = TextProcessor(config.text)
        self.full_text = ""
        self.xmax = 0.0
        self.phones: List[Tuple[float, float, str]] = []
        self.words: List[Tuple[float, float, str]] = []
        self.last_file_written: Optional[str] = None

    def frames_to_seconds(self, frames: float) -> float:
        a = self.config.preprocessing.audio
        return frames * a.fft_hop_size / a.output_sampling_rate

    def get_tokens_from_duration_and_labels(
        self,
        log_duration_predictions: np.ndarray,
        duration_control: float,
        text: np.ndarray,
        raw_text: str,
    ):
        duration_frames = np.clip(
            np.round(np.exp(log_duration_predictions) - 1) * duration_control, 0, None
        ).astype(int).tolist()
        labels = self.text_processor.token_sequence_to_text_sequence(text.tolist())
        if len(duration_frames) != len(labels):
            raise ValueError(
                f"can't synthesize {raw_text}: {len(duration_frames)} durations vs "
                f"{len(labels)} labels"
            )
        labels_no_pad = [t for t in labels if t != PAD_SYMBOL]
        durations_no_pad = duration_frames[: len(labels_no_pad)]
        xmax_seconds = self.frames_to_seconds(sum(durations_no_pad))

        words: List[Tuple[float, float, str]] = []
        phones: List[Tuple[float, float, str]] = []
        raw_text_words = raw_text.split()
        current_word_duration = 0.0
        last_phone_end = 0.0
        last_word_end = 0.0
        for label, duration in zip(labels_no_pad, durations_no_pad):
            phone_duration = self.frames_to_seconds(duration)
            current_phone_end = last_phone_end + phone_duration
            phones.append((last_phone_end, current_phone_end, label))
            last_phone_end = current_phone_end
            current_word_duration += phone_duration
            if (label == " " or len(phones) == len(labels_no_pad)) and len(
                words
            ) < len(raw_text_words):
                current_word_end = last_word_end + current_word_duration
                words.append(
                    (last_word_end, current_word_end, raw_text_words[len(words)])
                )
                last_word_end = current_word_end
                current_word_duration = 0.0
        return xmax_seconds, phones, words

    def save_aligned_text_to_file(
        self, max_seconds, phones, words, full_text, speaker, language
    ):  # pragma: no cover - abstract
        raise NotImplementedError

    def on_predict_batch_end(self, outputs, batch):
        durations = np.asarray(outputs["duration_prediction"])
        for i in range(durations.shape[0]):
            src_len = int(np.asarray(batch["src_lens"])[i])
            xmax_seconds, phones, words = self.get_tokens_from_duration_and_labels(
                durations[i][:src_len],
                float(np.asarray(batch.get("duration_control", np.ones(1)))[min(i, 0)]),
                np.asarray(batch["text"])[i][:src_len],
                batch["raw_text"][i],
            )
            self.full_text += batch["raw_text"][i]
            self.phones += [(s + self.xmax, e + self.xmax, t) for s, e, t in phones]
            self.words += [(s + self.xmax, e + self.xmax, t) for s, e, t in words]
            self.xmax += xmax_seconds
            if batch["is_last_input_chunk"][i]:
                self.save_aligned_text_to_file(
                    self.xmax,
                    self.phones,
                    self.words,
                    self.full_text,
                    batch["speaker"][i],
                    batch["language"][i],
                )
                self.full_text = ""
                self.xmax = 0.0
                self.phones = []
                self.words = []


def _write_textgrid(
    path: str,
    xmax: float,
    tiers: List[Tuple[str, List[Tuple[float, float, str]]]],
) -> None:
    """Minimal Praat long-format TextGrid serializer."""
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {xmax}",
        "tiers? <exists>",
        f"size = {len(tiers)}",
        "item []:",
    ]
    for t_i, (name, intervals) in enumerate(tiers, start=1):
        lines += [
            f"    item [{t_i}]:",
            '        class = "IntervalTier"',
            f'        name = "{name}"',
            "        xmin = 0",
            f"        xmax = {xmax}",
            f"        intervals: size = {len(intervals)}",
        ]
        for i, (s, e, label) in enumerate(intervals, start=1):
            label = label.replace('"', '""')
            lines += [
                f"        intervals [{i}]:",
                f"            xmin = {s}",
                f"            xmax = {e}",
                f'            text = "{label}"',
            ]
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf8")


class PredictionWritingTextGridWriter(PredictionWritingAlignedTextWriter):
    """TextGrid with phones/phone annotations/words/word annotations tiers."""

    def __init__(self, config, global_step, output_dir: Path, output_key: str):
        a = config.preprocessing.audio
        super().__init__(
            config=config,
            global_step=global_step,
            output_key=output_key,
            file_extension=f"{a.input_sampling_rate}-{a.spec_type}.TextGrid",
            save_dir=Path(output_dir) / "textgrids",
        )

    def save_aligned_text_to_file(
        self, max_seconds, phones, words, full_text, speaker, language
    ):
        basename = slugify(full_text)

        def snapped(intervals):
            out = []
            for i in range(len(intervals)):
                out.append(
                    (
                        intervals[i - 1][1] if i > 0 else 0.0,
                        intervals[i][1] if i < len(intervals) - 1 else max_seconds,
                        intervals[i][2],
                    )
                )
            return out

        sp = snapped(phones)
        sw = snapped(words)
        empty = lambda iv: [(s, e, "") for s, e, _ in iv]  # noqa: E731
        filename = self.get_filename(basename, speaker, language)
        _write_textgrid(
            filename,
            max_seconds,
            [
                ("phones", sp),
                ("phone annotations", empty(sp)),
                ("words", sw),
                ("word annotations", empty(sw)),
            ],
        )
        self.last_file_written = filename


def _readalong_xml(words: List[Tuple[float, float, str]], language: str) -> str:
    """ReadAlong-Studio .readalong XML with word-level time/dur markup."""
    import html

    body = []
    for i, (start, end, label) in enumerate(words):
        if i:
            body.append(" ")
        body.append(
            f'<w time="{start:.3f}" dur="{end - start:.3f}">'
            f"{html.escape(label)}</w>"
        )
    text = "".join(body)
    return (
        '<?xml version="1.0" encoding="utf-8"?>\n'
        f'<read-along version="1.0"><text xml:lang="{language}"><body><div type="page">'
        f"<p><s>{text}</s></p></div></body></text></read-along>\n"
    )


class PredictionWritingReadAlongWriter(PredictionWritingAlignedTextWriter):
    """ReadAlong XML."""

    def __init__(self, config, global_step, output_dir: Path, output_key: str):
        a = config.preprocessing.audio
        super().__init__(
            config=config,
            global_step=global_step,
            output_key=output_key,
            file_extension=f"{a.input_sampling_rate}-{a.spec_type}.readalong",
            save_dir=Path(output_dir) / "readalongs",
        )

    def save_aligned_text_to_file(
        self, max_seconds, phones, words, full_text, speaker, language
    ):
        basename = slugify(full_text)
        filename = self.get_filename(basename, speaker, language)
        Path(filename).write_text(_readalong_xml(words, language), encoding="utf8")
        self.last_file_written = filename


class PredictionWritingOfflineRASWriter(PredictionWritingAlignedTextWriter):
    """Single-file offline HTML readalong wrapping the wav output."""

    def __init__(self, config, global_step, output_dir: Path, output_key: str, wav_writer):
        a = config.preprocessing.audio
        super().__init__(
            config=config,
            global_step=global_step,
            output_key=output_key,
            file_extension=f"{a.input_sampling_rate}-{a.spec_type}.html",
            save_dir=Path(output_dir) / "readalongs",
        )
        self.wav_writer = wav_writer

    def save_aligned_text_to_file(
        self, max_seconds, phones, words, full_text, speaker, language
    ):
        import base64
        import html

        basename = slugify(full_text)
        wav_file = Path(self.wav_writer.get_filename(basename, speaker, language))
        audio_tag = ""
        if wav_file.exists():
            b64 = base64.b64encode(wav_file.read_bytes()).decode("ascii")
            audio_tag = (
                f'<audio id="ras-audio" controls '
                f'src="data:audio/wav;base64,{b64}"></audio>'
            )
        spans = " ".join(
            f'<span class="ras-word" data-time="{s:.3f}" data-dur="{e - s:.3f}">'
            f"{html.escape(t)}</span>"
            for s, e, t in words
        )
        doc = (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>ReadAlong</title></head><body>"
            f"<h1>ReadAlong</h1>{audio_tag}<p>{spans}</p>"
            "<script>const a=document.getElementById('ras-audio');"
            "if(a){a.ontimeupdate=()=>{document.querySelectorAll('.ras-word')"
            ".forEach(w=>{const t=+w.dataset.time,d=+w.dataset.dur;"
            "w.style.background=(a.currentTime>=t&&a.currentTime<t+d)?'#ff6':'';});};}"
            "</script></body></html>"
        )
        filename = self.get_filename(basename, speaker, language)
        Path(filename).write_text(doc, encoding="utf8")
        self.last_file_written = filename


class PredictionWritingWavWriter(PredictionWriterBase):
    """Vocoder synthesis + per-chunk trim + reassembly + PCM16 save.
    `vocoder` is a callable (mel [B, T, K]) -> (wav [B, T*hop], sr): a
    HiFiGAN or Griffin-Lim."""

    def __init__(
        self,
        config,
        global_step: int,
        output_dir: Path,
        output_key: str,
        vocoder,
        vocoder_global_step: int = 0,
        output_hop_size: Optional[int] = None,
    ):
        super().__init__(
            config=config,
            file_extension="pred.wav",
            global_step=global_step,
            save_dir=Path(output_dir) / "wav",
            include_global_step_in_filename=True,
        )
        self.output_key = output_key
        self.vocoder = vocoder
        self.output_hop_size = (
            output_hop_size or config.preprocessing.audio.fft_hop_size
        )
        self.file_extension = self.sep.join(
            (f"v_ckpt={vocoder_global_step}", self.file_extension)
        )
        self.full_text = ""
        self.full_wav: Optional[np.ndarray] = None
        self.last_file_written: Optional[str] = None

    def on_predict_batch_end(self, outputs, batch):
        mel = np.asarray(outputs[self.output_key])
        lens = np.asarray(outputs["tgt_lens"])
        # vocode only up to a 128-multiple of the longest utterance: the
        # vocoder's cost scales with T (the Synthesizer trims the same way)
        t_need = -(-max(int(lens.max()), 1) // 128) * 128
        wavs, sr = self.vocoder(mel[:, : min(t_need, mel.shape[1])])
        wavs = np.asarray(wavs)
        if wavs.shape[0] != mel.shape[0]:
            raise ValueError(f"the vocoder returned {wavs.shape[0]} rows for {mel.shape[0]}")
        for i in range(wavs.shape[0]):
            trimmed = wavs[i][: int(lens[i]) * self.output_hop_size]
            self.full_wav = (
                trimmed
                if self.full_wav is None
                else np.concatenate([self.full_wav, trimmed])
            )
            self.full_text += batch["raw_text"][i]
            if batch["is_last_input_chunk"][i]:
                basename = slugify(self.full_text)
                filename = self.get_filename(
                    basename, batch["speaker"][i], batch["language"][i]
                )
                save_wav(Path(filename), self.full_wav, sr)
                self.last_file_written = filename
                self.full_wav = None
                self.full_text = ""


class ScorerWriter(PredictionWriterBase):
    """Each utterance's losses and coverage scores, written by ``finalize``
    to ``scores-{step}.psv`` sorted by (-total_loss, trigram coverage)
    (``writers.py:436-477``)."""

    def __init__(self, config, global_step, output_dir: Path, output_key: str):
        super().__init__(config=config, file_extension="psv", global_step=global_step,
                         save_dir=Path(output_dir))
        self.output_key = output_key
        self.rows: List[dict] = []

    def on_predict_batch_end(self, outputs, batch):
        losses = outputs.get("losses", {})
        for i in range(len(batch["basename"])):
            row = {"basename": batch["basename"][i], "speaker": batch["speaker"][i],
                   "language": batch["language"][i]}
            for k, v in losses.items():
                row[f"{k}_loss"] = float(np.asarray(v).reshape(-1)[0])
            for key in ("phone_coverage_score", "trigram_coverage_score"):
                if key in batch:
                    row[key] = float(batch[key][i])
            self.rows.append(row)

    def finalize(self) -> Path:
        self.rows.sort(key=lambda r: (-r.get("total_loss", 0.0),
                                      r.get("trigram_coverage_score", 0.0)))
        path = self.save_dir / f"scores-{self.global_step}.psv"
        write_filelist(self.rows, path)
        return path


def get_synthesis_output_writers(
    output_type: Sequence[SynthesizeOutputFormats],
    output_dir: Path,
    config: FastSpeech2Config,
    output_key: str,
    global_step: int,
    vocoder=None,
    vocoder_global_step: int = 0,
    output_hop_size: Optional[int] = None,
    return_scores: bool = False,
) -> Dict[Any, PredictionWriterBase]:
    """The writers of `output_type`, keyed by format, and with
    `return_scores` the ``ScorerWriter`` under "score"; wav and
    readalong-html need a vocoder."""
    writers: Dict[Any, PredictionWriterBase] = {}
    if return_scores:
        writers["score"] = ScorerWriter(config, global_step, output_dir, output_key)
    needs_wav = (
        SynthesizeOutputFormats.wav in output_type
        or SynthesizeOutputFormats.readalong_html in output_type
    )
    if needs_wav:
        if vocoder is None:
            raise ValueError(
                "We cannot synthesize waveforms without a vocoder. Please "
                "ensure that a vocoder is specified."
            )
        writers[SynthesizeOutputFormats.wav] = PredictionWritingWavWriter(
            config, global_step, output_dir, output_key, vocoder,
            vocoder_global_step, output_hop_size,
        )
    if SynthesizeOutputFormats.spec in output_type:
        writers[SynthesizeOutputFormats.spec] = PredictionWritingSpecWriter(
            config, global_step, output_dir, output_key
        )
    if SynthesizeOutputFormats.textgrid in output_type:
        writers[SynthesizeOutputFormats.textgrid] = PredictionWritingTextGridWriter(
            config, global_step, output_dir, output_key
        )
    if SynthesizeOutputFormats.readalong_xml in output_type:
        writers[SynthesizeOutputFormats.readalong_xml] = (
            PredictionWritingReadAlongWriter(
                config, global_step, output_dir, output_key
            )
        )
    if SynthesizeOutputFormats.readalong_html in output_type:
        writers[SynthesizeOutputFormats.readalong_html] = (
            PredictionWritingOfflineRASWriter(
                config, global_step, output_dir, output_key,
                writers[SynthesizeOutputFormats.wav],
            )
        )
    return writers
