"""Batch-streaming synthesis HTTP server (counterpart of the JAX package's
``serving/server.py``, stdlib HTTP only):

 - POST /synthesize  body: JSON {"text": str, "language"?, "speaker"?,
   "pitch"?, "energy"?, "duration"?, "format"? ("wav"|"mel")}
   -> for "wav": a RIFF/PCM16 stream whose data arrives chunk by chunk
   (Transfer-Encoding: chunked; the RIFF sizes use the 0xFFFFFFFF streaming
   convention). For "mel": the concatenated [T, n_mels] float32 mel as .npy.
   A wav request with "low_latency": true (and "window"?, frames) bypasses
   the micro-batcher: one acoustic forward, then the vocoder window by
   window (``Synthesizer.synthesize_stream``), each window sent as it is
   vocoded.
 - GET /health -> {"status": "ok", "global_step": N, "sample_rate": SR}
 - GET /stats -> serving counters and batch latency percentiles.

Long inputs are split with the corpus-informed chunker; each chunk is one
row of a device batch. A background worker micro-batches chunks across
concurrent requests (grouped by (language, speaker, controls)) and pads each
group to `max_batch` rows. A server-wide style reference (a wav) conditions
every request of a global-style-token model. A ``.fs2x`` artifact
(``export-serving``) serves through ``ExportedSynthesizer``: its exported
programs answer the batched requests and its window programs the
low-latency ones.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import struct
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def wav_stream_header(sample_rate: int, channels: int = 1, bits: int = 16) -> bytes:
    """RIFF header for a stream of unknown length (sizes set to 0xFFFFFFFF;
    players treat the data chunk as unbounded)."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 0xFFFFFFFF),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate,
                        block_align, bits),
            b"data",
            struct.pack("<I", 0xFFFFFFFF),
        ]
    )


def pcm16(wav: np.ndarray) -> bytes:
    """float waveform in [-1, 1] -> little-endian PCM16 bytes (the writers'
    encoding, synthesis/writers.py wav path)."""
    x = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


class _ChunkJob:
    """One text chunk awaiting synthesis; resolved with (mel, wav|None)."""

    __slots__ = ("text", "key", "future")

    def __init__(self, text: str, key: tuple):
        self.text = text
        self.key = key
        self.future: Future = Future()


class _Stats:
    """Thread-safe serving counters surfaced at GET /stats."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started_at = time.time()
        self.counters: collections.Counter = collections.Counter()
        # rolling window of device-dispatch wall times (seconds)
        self._batch_seconds: collections.deque = collections.deque(maxlen=512)

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def record_batch(self, occupied: int, size: int, seconds: float) -> None:
        with self._lock:
            self.counters["batches_dispatched"] += 1
            self.counters["rows_occupied"] += occupied
            self.counters["rows_dispatched"] += size
            self._batch_seconds.append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            lat = list(self._batch_seconds)
            out["uptime_s"] = round(time.time() - self.started_at, 3)
        dispatched = out.get("rows_dispatched", 0)
        if dispatched:
            out["batch_occupancy"] = round(
                out.get("rows_occupied", 0) / dispatched, 4
            )
        if lat:
            lat_ms = sorted(s * 1000.0 for s in lat)

            def pct(p):
                i = min(len(lat_ms) - 1, int(round(p / 100 * (len(lat_ms) - 1))))
                return round(lat_ms[i], 2)

            out["batch_ms"] = {
                "p50": pct(50), "p95": pct(95), "p99": pct(99),
                "window": len(lat_ms),
            }
        return out


class _Batcher:
    """Background micro-batcher: drains the job queue, groups consecutive
    jobs that share a (language, speaker, controls) key, pads the group to
    `max_batch` rows (one batch shape) and runs ONE predict call."""

    def __init__(self, synthesizer, max_batch: int = 8,
                 batch_window_ms: float = 5.0, stats: Optional[_Stats] = None,
                 style_reference=None):
        self.synthesizer = synthesizer
        self.style_reference = style_reference
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1000.0
        self.stats = stats or _Stats()
        self.jobs: "queue.Queue[Optional[_ChunkJob]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, job: _ChunkJob) -> None:
        self.jobs.put(job)

    def stop(self) -> None:
        self.jobs.put(None)
        self._thread.join(timeout=5)

    def _take_group(self) -> Optional[List[_ChunkJob]]:
        first = self.jobs.get()
        if first is None:
            return None
        group = [first]
        deadline = None
        while len(group) < self.max_batch:
            try:
                timeout = self.batch_window if deadline is None else deadline
                job = self.jobs.get(timeout=timeout)
            except queue.Empty:
                break
            if job is None:
                self.jobs.put(None)  # propagate shutdown
                break
            if job.key != first.key:
                # different controls can't share the batch; requeue and stop
                self.jobs.put(job)
                break
            group.append(job)
            deadline = 0.001
        return group

    def _run(self) -> None:
        while True:
            group = self._take_group()
            if group is None:
                return
            texts = [j.text for j in group]
            # pad to the fixed batch shape, as the JAX server does
            while len(texts) < self.max_batch:
                texts.append(texts[0])
            language, speaker, pitch, energy, duration = group[0].key
            t0 = time.time()
            try:
                result = self.synthesizer.synthesize(
                    texts,
                    language=language,
                    speaker=speaker,
                    pitch_control=pitch,
                    energy_control=energy,
                    duration_control=duration,
                    style_reference=self.style_reference,
                )
                self.stats.record_batch(
                    len(group), self.max_batch, time.time() - t0
                )
                for i, job in enumerate(group):
                    wav = result.wavs[i] if result.wavs is not None else None
                    job.future.set_result(
                        (result.mels[i], wav, result.sample_rate)
                    )
            except Exception as exc:  # surface to every waiting request
                self.stats.incr("batch_errors")
                for job in group:
                    if not job.future.done():
                        job.future.set_exception(exc)


class SynthesisServer:
    """Resident streaming server around a loaded Synthesizer."""

    def __init__(self, synthesizer, host: str = "127.0.0.1", port: int = 8777,
                 max_batch: int = 8, batch_window_ms: float = 5.0,
                 global_step: int = 0, style_reference=None):
        self.synthesizer = synthesizer
        self.global_step = global_step
        self.style_reference = style_reference
        self.stats = _Stats()
        self.batcher = _Batcher(synthesizer, max_batch, batch_window_ms, stats=self.stats,
                                style_reference=style_reference)
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple:
        return self.httpd.server_address

    def start(self) -> None:
        """Serve in a background thread (tests / embedding)."""
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._serve_thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)

    # -- request handling -------------------------------------------------

    def _chunks_for(self, text: str, language: Optional[str]) -> List[str]:
        from ..synthesis.prepare import chunk_text_for_model

        syn = self.synthesizer
        return chunk_text_for_model(text, language, syn.config, syn.stats)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/stats":
                    self._json(200, server.stats.snapshot())
                    return
                if self.path != "/health":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                syn = server.synthesizer
                sr = (
                    syn.config.preprocessing.audio.output_sampling_rate
                    if syn.vocoder is not None
                    else None
                )
                self._json(200, {
                    "status": "ok",
                    "global_step": server.global_step,
                    "sample_rate": sr,
                    "has_vocoder": syn.vocoder is not None,
                })

            def _chunked(self, data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")
                self.wfile.flush()

            def do_POST(self):
                if self.path != "/synthesize":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                server.stats.incr("requests")
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    text = req["text"]
                except (KeyError, ValueError) as exc:
                    server.stats.incr("request_errors")
                    self._json(400, {"error": f"bad request: {exc}"})
                    return
                fmt = req.get("format", "wav")
                syn = server.synthesizer
                if fmt == "wav" and syn.vocoder is None:
                    self._json(400, {"error": "no vocoder loaded; use format=mel"})
                    return
                key = (
                    req.get("language"),
                    req.get("speaker"),
                    float(req.get("pitch", 1.0)),
                    float(req.get("energy", 1.0)),
                    float(req.get("duration", 1.0)),
                )
                if fmt == "wav" and req.get("low_latency"):
                    self._low_latency(req, text)
                    return

                try:
                    chunks = server._chunks_for(text, req.get("language"))
                except Exception as exc:
                    self._json(400, {"error": str(exc)})
                    return
                jobs = []
                for c in chunks:
                    job = _ChunkJob(c, key)
                    server.batcher.submit(job)
                    jobs.append(job)
                server.stats.incr("chunks", len(jobs))

                if fmt == "mel":
                    try:
                        mels = [j.future.result(timeout=600)[0] for j in jobs]
                    except Exception as exc:
                        self._json(500, {"error": str(exc)})
                        return
                    buf = BytesIO()
                    np.save(buf, np.concatenate(mels, axis=0))
                    body = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Chunks", str(len(jobs)))
                    self.end_headers()
                    self.wfile.write(body)
                    return

                # wav: stream chunk-by-chunk while the rest is in flight
                try:
                    mel0, wav0, sr = jobs[0].future.result(timeout=600)
                except Exception as exc:
                    self._json(500, {"error": str(exc)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Chunks", str(len(jobs)))
                self.end_headers()
                self._chunked(wav_stream_header(sr))
                self._chunked(pcm16(wav0))
                try:
                    for job in jobs[1:]:
                        _mel, wav, _sr = job.future.result(timeout=600)
                        self._chunked(pcm16(wav))
                except Exception as exc:
                    # the 200 header is already out; end the chunked stream
                    # cleanly so the client sees a well-formed (short) body —
                    # detectable against the X-Chunks header — instead of a
                    # silently dropped connection
                    logger.error(f"wav stream aborted mid-response: {exc}")
                    self.close_connection = True
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass  # client already gone

            def _low_latency(self, req: dict, text: str) -> None:
                """Windowed streaming (``server.py:324-380``): the window
                (frames) is checked against [1, 1024] and rounded up to a
                multiple of 64 within [64, 1024], so clients reach a few
                slice shapes only; a failure before the first window is a
                400, one after it closes the connection."""
                server.stats.incr("low_latency_requests")
                syn = server.synthesizer
                try:
                    window = int(req.get("window", 128))
                except (TypeError, ValueError):
                    self._json(400, {"error": "window must be an int"})
                    return
                if not 1 <= window <= 1024:
                    self._json(400, {"error": "window must be in [1, 1024] frames"})
                    return
                window = max(64, min(1024, 64 * -(-window // 64)))
                try:
                    gen = syn.synthesize_stream(
                        text, window=window, language=req.get("language"),
                        speaker=req.get("speaker"),
                        pitch_control=float(req.get("pitch", 1.0)),
                        energy_control=float(req.get("energy", 1.0)),
                        duration_control=float(req.get("duration", 1.0)),
                        style_reference=server.style_reference,
                    )
                    first = next(gen)
                except Exception as exc:
                    self._json(400, {"error": str(exc)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._chunked(wav_stream_header(syn.vocoder.sample_rate))
                self._chunked(pcm16(first))
                try:
                    for seg in gen:
                        self._chunked(pcm16(seg))
                except Exception as exc:
                    logger.error(f"wav stream aborted mid-response: {exc}")
                    self.close_connection = True
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass

        return Handler


def serve(
    model_path,
    vocoder_path=None,
    host: str = "127.0.0.1",
    port: int = 8777,
    max_batch: int = 8,
    batch_window_ms: float = 5.0,
    max_frames: Optional[int] = None,
    vocoder_precision: str = "float32",
    vocoder_fused: bool = False,
    warmup: bool = False,
    device=None,
    use_ema: bool = False,
    style_reference=None,
    data_parallel: Optional[int] = None,
) -> SynthesisServer:
    """Load once, serve. Returns the (not yet started) server. The model
    runs on the CUDA card unless `device` is "cpu"; warmup builds the kernels
    and initialises the device libraries before the first request (for a
    ``.fs2x`` artifact: runs every exported program once); use_ema serves the
    EMA weights of a trainer's step=N/ directory; style_reference (a wav)
    conditions every request of a global-style-token model; data_parallel
    N splits each micro-batch's rows over N model replicas in this process,
    one a card (N CPU replicas with device "cpu"). A ``.fs2x`` artifact
    refuses the options fixed at export time, with the JAX package's
    message."""
    from ..synthesis.api import Synthesizer

    if str(model_path).endswith(".fs2x"):
        from ..synthesis.exported import ExportedSynthesizer

        rejected = {
            "--vocoder-path": vocoder_path,
            "--use-ema": use_ema or None,
            "--data-parallel": data_parallel,
            "--max-frames": max_frames,
            "--style-reference": style_reference,
            "--vocoder-precision": None if vocoder_precision == "float32" else vocoder_precision,
            "vocoder_fused": vocoder_fused or None,
        }
        bad = [k for k, v in rejected.items() if v]
        if bad:
            raise ValueError(
                f"{', '.join(bad)} cannot apply to a .fs2x artifact — these are fixed at "
                "export time (fs2t export-serving)"
            )
        syn = ExportedSynthesizer(model_path, device=device)
        if warmup:
            n = syn.warmup(max_batch)
            logger.info("warmup ran %d exported programs", n)
        return SynthesisServer(
            syn, host=host, port=port, max_batch=max_batch,
            batch_window_ms=batch_window_ms, global_step=syn.global_step,
        )

    syn = Synthesizer.from_checkpoint(
        model_path, vocoder_path=vocoder_path, max_frames=max_frames,
        vocoder_precision=vocoder_precision, vocoder_fused=vocoder_fused,
        data_parallel=data_parallel, device=device, use_ema=use_ema,
    )
    if warmup:
        n = syn.warmup(max_batch)
        logger.info("warmup made %d calls", n)
    return SynthesisServer(
        syn, host=host, port=port, max_batch=max_batch,
        batch_window_ms=batch_window_ms, global_step=syn.global_step,
        style_reference=style_reference,
    )
