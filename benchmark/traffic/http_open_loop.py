"""HTTP serving under open-loop Poisson arrivals: ``SynthesisServer``
(``serving/server.py``) on 127.0.0.1 at a free port, given a
``Synthesizer`` built in memory, and a load generator in a process of its
own (``common/loadgen.py``) that POSTs texts at their due times and reads
the wav bodies.

Parameters: ``rate`` (requests a second, fixed in the cell: about four
fifths of the knee a sweep found), ``median_chars``, ``sigma``, ``chars``
[lo, hi] (lognormal text lengths, clipped), ``max_batch``,
``batch_window_ms``, ``warmup_requests``, ``drain_seconds`` (how long after the window the
requests due in it may take to finish), ``keep``, ``trace_seconds`` and
``limits``. The arrival gaps and text lengths are drawn once from a fixed
generator, and the run's seed shuffles them and draws the words.

Every request due in the window counts: ``serve_p95_ms`` is the 95th
percentile of due time to last byte over all of them, a failed or
unfinished one counting as missing the limit (infinite). ``correct``
compares a sample of the batcher's calls with the reference
(``common.serving``), and checks that the body of every request served as
one chunk of a sampled call carries that call's wav (``body_mismatch``)."""

from __future__ import annotations

import gc
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.common import corpus, serving
from benchmark.common.harness import Check, Outcome, Readings
from benchmark.common.trace import DeviceTracer, Spans
from benchmark.reference.numerics import Numerics

LOADGEN = Path(__file__).resolve().parent.parent / "common" / "loadgen.py"


def schedule(seed: int, p: dict, seconds: float) -> tuple:
    """(texts, due times): Poisson arrivals at the cell's rate over `seconds`."""
    n = max(1, int(round(p["rate"] * seconds)))
    sizes = corpus.size_rng("serve")
    gaps = sizes.exponential(1.0 / p["rate"], n)
    gaps *= seconds / gaps.sum()  # n arrivals in the window, whatever their order
    lengths = np.clip(np.round(sizes.lognormal(math.log(p["median_chars"]), p["sigma"], n)),
                      p["chars"][0], p["chars"][1]).astype(int)
    rng = np.random.default_rng(seed % (1 << 63))
    gaps, lengths = gaps[rng.permutation(n)], lengths[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps  # each request due when the gaps before it have passed
    return [corpus.text_of_length(rng, int(c)) for c in lengths], [float(t) for t in due]


def pcm16_sha1(wav: np.ndarray) -> str:
    """SHA-1 of a float wav's PCM16 encoding (clipped to [-1, 1], times 32767)."""
    x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    return hashlib.sha1((x * 32767.0).astype("<i2").tobytes()).hexdigest()


def load(server, texts, due, workdir: Path, p: dict, tag: str) -> list:
    host, port = server.address[:2]
    path = workdir / f"schedule-{tag}.json"
    path.write_text(json.dumps({"host": host, "port": port, "texts": texts, "due": due,
                                "threads": p.get("threads", 256),
                                "timeout": p["drain_seconds"] + max(due, default=0.0)}))
    out = path.with_suffix(".out")
    with open(out, "w") as f:  # a file: a pipe would fill and stall the generator
        proc = subprocess.Popen([sys.executable, str(LOADGEN), str(path)], stdout=f)
    proc.out = out
    return proc


def collect(proc) -> list:
    proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the load generator exited with {proc.returncode}")
    lines = proc.out.read_text().splitlines()
    return sorted((json.loads(line) for line in lines if line.strip()), key=lambda r: r["i"])


def run(run) -> Outcome:
    from fastspeech2_lightning_tpu_torch.serving.server import SynthesisServer

    p, dev = run.params, run.device
    cfg = {k: run.config[k] for k in ("model", "preprocessing", "text", "training")}
    synth = serving.build(run, cfg)
    rec = serving.Recorder(synth, run.seed, keep=p["keep"])
    server = SynthesisServer(synth, host="127.0.0.1", port=0, max_batch=p["max_batch"],
                             batch_window_ms=p["batch_window_ms"])
    server.start()
    try:
        synth.warmup(p["max_batch"])
        warm_texts, warm_due = schedule(run.seed + 1, dict(p, rate=p["rate"]),
                                        p["warmup_requests"] / p["rate"])
        longest = corpus.text_of_length(np.random.default_rng(run.seed % (1 << 63)),
                                        p["chars"][1])
        warm = collect(load(server, [longest] + warm_texts, [0.0] + [t + 0.5 for t in warm_due],
                            run.workdir, p, "warm"))
        if any(r["status"] != 200 for r in warm):
            raise RuntimeError(f"warm-up requests failed: {[r for r in warm if r['status'] != 200][:2]}")
        serving.plant(synth, run.fault)
        texts, due = schedule(run.seed, p, run.seconds)
        spans = Spans()
        tracer = DeviceTracer(run.trace, p["trace_seconds"], spans)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = run.setup_s()
        before = server.stats.snapshot()
        rec.counting = True
        tracer.start()
        rec.tracing = tracer.prof is not None
        proc = load(server, texts, due, run.workdir, p, "window")
        while proc.poll() is None:
            time.sleep(0.02)
            tracer.poll()
            rec.tracing = tracer.prof is not None
        tracer.stop()
        rows = collect(proc)
        rec.counting = False
        after = server.stats.snapshot()
    finally:
        server.shutdown()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 and r["done"] is not None
           else math.inf for r in rows]
    failed = sum(1 for x in lat if not math.isfinite(x))
    window = max(run.seconds, max((r["done"] or 0.0) for r in rows))
    readings = Readings(
        window_s=window, config=run.config, params=p,
        counters={"calls": rec.calls, "forwards": rec.forwards, "memory_peak_bytes": memory,
                  "rows_occupied": after.get("rows_occupied", 0) - before.get("rows_occupied", 0),
                  "rows_dispatched": (after.get("rows_dispatched", 0)
                                      - before.get("rows_dispatched", 0))},
        spans={"request_ms": lat, "late_ms": [(r["sent"] - r["due"]) * 1e3 for r in rows]},
        records={"work": rec.work, "traced": rec.traced}, trace=tracer.result)
    served = rec.sample()
    del synth, server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    hop = 1
    for u in run.config["vocoder"]["upsample_rates"]:
        hop *= u
    want = serving.reference_outputs(run, cfg, served, Numerics("float32"), Numerics("float32"))
    checks = serving.compare(served, want, hop, p["limits"])
    bad, seen = body_mismatches(served, texts, rows)
    checks.append(Check("body_mismatch", float(bad) if seen else math.inf, 0.0))
    return Outcome(attempted=len(rows), failed=failed,
                   end_to_end={"serve_p95_ms": percentile(lat, 95), "setup_s": setup_s},
                   checks=checks, readings=readings, memory_peak_bytes=memory)


def percentile(values, q: float) -> float:
    """The q-th percentile (nearest rank) of every value, inf counted."""
    xs = sorted(values)
    return float(xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))])


def body_mismatches(served, texts, rows) -> tuple:
    """(mismatches, compared) over the requests served as one chunk whose
    text a sampled call held: their body's PCM against that call's wav."""
    by_text = {}
    for s in served:
        for t, w in zip(s.texts, s.wavs):
            by_text.setdefault(t, pcm16_sha1(w))
    bad = seen = 0
    for r in rows:
        t = texts[r["i"]]
        if r.get("chunks") == "1" and t in by_text:
            seen += 1
            bad += r["sha1"] != by_text[t]
    return bad, seen


def control(run, mode: str) -> list:
    """The reference with its forward in `mode` and its vocoder in bfloat16
    in the program's place, on batches of the cell's texts."""
    p = run.params
    cfg = {k: run.config[k] for k in ("model", "preprocessing", "text", "training")}
    texts, _ = schedule(run.seed, p, 10.0)
    texts = [t for t in texts if len(t) <= 160]  # texts the chunker leaves whole
    longest = max(texts, key=len)
    B = p["max_batch"]
    batches = [[longest] + texts[:B - 1]] + [texts[i:i + B] for i in range(B, B * p["keep"], B)]
    hop = 1
    for u in run.config["vocoder"]["upsample_rates"]:
        hop *= u
    got = serving.control_served(run, cfg, batches, mode, "bfloat16", hop)
    want = serving.reference_outputs(run, cfg, got, Numerics("float32"), Numerics("float32"))
    return serving.compare(got, want, hop, p["limits"])
