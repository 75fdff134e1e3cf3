"""Bulk synthesis through the Python API: one caller in a closed loop calls
``Synthesizer.synthesize`` on a batch of texts with ``vocode=True`` and
keeps the wavs in memory.

Parameters: ``batch`` (texts a call), ``chars`` [lo, hi] (text lengths,
uniform: ``pool_batches`` x ``batch`` of them, the same set in every run,
dealt into batches by the seed), ``pool_batches`` (batches generated, used
in turn), ``keep`` (calls sampled for the check), ``trace_seconds`` and
``limits``.

Set-up calls every batch of the pool once, so every shape the window meets
has run before it. The window opens after that and closes at the first
call that returns ``--seconds`` later; every call ends with its wavs on the host, so
each call's audio is complete when it is counted. ``correct`` compares a
sample of the window's calls, with the longest text's, against the plain
reference (``common.serving``)."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.common import corpus, serving
from benchmark.common.harness import Outcome, Readings
from benchmark.common.trace import DeviceTracer, Spans
from benchmark.reference.numerics import Numerics


def program_config(run) -> dict:
    return {k: run.config[k] for k in ("model", "preprocessing", "text", "training")}


def run(run) -> Outcome:
    p, dev = run.params, run.device
    cfg = program_config(run)
    pool = corpus.text_batches(run.seed, p["pool_batches"], p["batch"], p["chars"])
    synth = serving.build(run, cfg)
    rec = serving.Recorder(synth, run.seed, keep=p["keep"])
    synth.warmup(p["batch"])
    for texts in pool:
        synth.synthesize(texts, vocode=True)
    serving.plant(synth, run.fault)
    hop = synth.vocoder.hop
    sr = synth.vocoder.sample_rate
    spans = Spans()
    tracer = DeviceTracer(run.trace, p["trace_seconds"], spans)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = run.setup_s()
    rec.counting = True
    tracer.start()
    rec.tracing = tracer.prof is not None
    t0 = time.perf_counter()
    calls, frames, i = 0, 0, 0
    while True:
        with spans.span("synthesize"):
            result = synth.synthesize(pool[i % len(pool)], vocode=True)
        i += 1
        calls += 1
        frames += sum(len(w) for w in result.wavs) // hop
        tracer.poll()
        rec.tracing = tracer.prof is not None
        if time.perf_counter() - t0 >= run.seconds:
            break
    window = time.perf_counter() - t0
    tracer.stop()
    rec.counting = False
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    readings = Readings(window_s=window, config=run.config, params=p,
                        counters={"calls": calls, "forwards": rec.forwards,
                                  "memory_peak_bytes": memory},
                        spans=dict(spans.spans),
                        records={"work": rec.work, "traced": rec.traced},
                        trace=tracer.result)
    served = rec.sample()
    del synth
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = serving.reference_outputs(run, cfg, served, Numerics("float32"),
                                     Numerics("float32"))
    checks = serving.compare(served, want, hop, p["limits"])
    return Outcome(attempted=calls * p["batch"], failed=0,
                   end_to_end={"synth_audio_s_per_s": frames * hop / sr / window,
                               "setup_s": setup_s},
                   checks=checks, readings=readings, memory_peak_bytes=memory)


def control(run, mode: str) -> list:
    """The reference with its forward in `mode` (the vocoder in bfloat16
    below the vocoder's float32) in the program's place, on the cell's
    first batches."""
    p = run.params
    cfg = program_config(run)
    pool = corpus.text_batches(run.seed, p["pool_batches"], p["batch"], p["chars"])
    longest = max(range(len(pool)), key=lambda i: max(map(len, pool[i])))
    batches = [pool[longest]] + pool[:p["keep"]]
    hop = 1
    for u in run.config["vocoder"]["upsample_rates"]:
        hop *= u
    got = serving.control_served(run, cfg, batches, mode, "bfloat16", hop)
    want = serving.reference_outputs(run, cfg, got, Numerics("float32"), Numerics("float32"))
    return serving.compare(got, want, hop, p["limits"])
