#!/usr/bin/env python3
"""Run the PyTorch port's serving, training, synthesis and preprocessing
paths on one CUDA card and check them.

    python3 chip_smoke.py

Drives ``fastspeech2_lightning_tpu_torch`` (never the JAX package) through
its own entry points and fails, exiting non-zero, if any phase fails:

 1. device: the card's name and power limit, as nvidia-smi reports them;
 2. build: one nvcc per ``csrc/*.cu`` for sm_90a, all started together;
 3. attention_fwd against its plain version at the decoder's serving shape
    (with a ragged and with a full key mask) and two others; wall times of
    the kernel, the plain version and F.scaled_dot_product_attention (a
    yardstick only), and device times of kernel and SDPA;
 4. the MRF stage (18 mrf_conv launches) against its plain version for the
    HiFiGAN V1 stages C = 128/64/32 at B = 8 and 256 mel frames, in bf16 and
    in f32 (what serving launches): wall and device times of the stage and
    the wall time of its plain version (36 cuDNN convolutions, TF32 off);
 5. serving: the default FastSpeech2 config at full width and depth (4+4
    Conformer layers, d = 256, bf16) with seeded random weights and a seeded
    HiFiGAN V1, written as a .ckpt and an .npz and served by ``serve()``;
    8 concurrent /synthesize requests (4 wav, 4 mel), with both kernels'
    launch counts read around this phase (mrf_conv: 18 for every fused
    stage the vocoder ran);
 6. card against CPU: one f32 batch of the same weights on both;
 7-8. the training attention kernels (forward with dropout, backward)
    against their plain version at (16, 2, 1024 and 2048, 128), bf16 and f32,
    p = 0 and 0.2 with the same seed, on ragged masks with an item that has
    no valid key and one with a hole; the kept share of the mask; times of
    kernel, plain version and F.scaled_dot_product_attention (forward,
    forward+backward, and its backward alone), and in bf16 the device times
    of both kernels and of SDPA;
 9. MAS against its plain version, bit for bit, at B = 16, T 1024/2048,
    L 160/1000 and at the training corpus's top bucket (16, 2016, 192), with
    wall and device times;
 10. kernel C (CTC: the alpha chain alone, both chains side by side, the
    gradient) against its plain version at B = 16, T = 1024, L = 160, with
    wall and device times beside the bound and F.ctc_loss's (a yardstick);
 11. training: a seeded corpus (64 utterances to train on, 64 to validate),
    the default config at full width and depth in bf16 with batch 16, 8
    steps through the ``train`` CLI entry
    with a validation every 4 steps (EMA on, async checkpoints, the top 1
    kept), the training kernels' launch counts read around it and, apart,
    around each validation (A at p 0, B and C's alpha chain per validation
    batch); then a CLI run to step 12 in a subprocess, SIGTERMed after step
    10 (exit 0, a checkpoint at its last step), its resume to 12, one
    sentence synthesized from step=12 with and without EMA; then timings
    of the 64-utterance validation, synchronous saves, async ones (blocking
    part, written), a resume's load (the first run's step=8/ is kept for
    phase 29) and steps with ``prefetch_batches`` 2
    and 0 in turns (no save or validation among them) and with async saves;
 12. card against CPU: one f32 train step (2+2 layers, no dropout) from the
    same weights and batch, then one eval step of the same weights;
 13. kernels A and A' at each length bucket the trainer cut in phase 11,
    bf16, p = 0 and 0.2, on the bucket's own key mask and on a full one:
    against the plain version; wall and device times beside SDPA's; the
    share of key tiles each skips. The kernels' JSON line takes its
    training rows from the top bucket with its own mask at p = 0.2;
 14. kernel C as phase 10 at each length bucket the trainer cut in phase 11,
    with the bucket's text and mel lengths; its JSON entries take the top
    bucket;
 15. synthesis through the ``synthesize`` CLI entry, in-process, with the
    kernels' launch counts set to 0 before and read after each run: phase
    5's checkpoint and HiFiGAN on a filelist of 16 utterances (8 of 300-600
    characters that chunk), batches of 8, all five output formats; the
    same with Griffin-Lim (wav); phase 11's step=12 teacher-forced from its
    corpus on the 64-utterance validation list, batches of 16 (spec,
    TextGrid). Checks the file names, one file an utterance, the wav and
    spec lengths, the target mel lengths, and the launches (attention_fwd 8
    a batch, mas_width1 1 a teacher-forced batch, nothing else); prints
    each run's wall, the ms a batch of forward, vocoder and writers, and
    utterances and audio seconds a second. Then attention_fwd and
    mas_width1 against their plain versions on inputs the runs gave them;
 16. card against CPU through the same CLI: a 2+2-layer f32 model, one
    free-running and one teacher-forced batch (spec within 1e-4, TextGrid
    and ReadAlong byte-equal, durations equal), and one Griffin-Lim call
    (float wav within 1e-4);
 17. conditioned training: the default config with speakers, languages and
    global style tokens, bf16, batch 16, 8 steps through the ``train`` CLI on
    phase 11's corpus spoken by 2 speakers in 2 languages (the same batch
    shapes in the same order), one validation: launches a step as phase 11,
    the style encoder's BatchNorm statistics moved, step ms beside phase
    11's, peak memory; then phase 12's card-against-CPU steps on this config;
 18. serving its step=8/ with a seeded style-reference wav: a speaker x
    language grid of concurrent requests (8 attention_fwd a forward), the
    Synthesizer without a reference (style token 0) and with a second one
    (a different style embedding); card against CPU in f32;
 19. low-latency streaming over HTTP (phase 5's checkpoint, fused f32 HiFiGAN
    V1, windows of 128 frames): time to the first audio and to the whole
    body beside the batched wav's, in turns; mrf_conv launches a window (54);
    the stream against device_fn of each whole mel (TF32 off); the MRF stage
    at the three B = 1 window shapes against its plain version;
 20. a phone-level and a phonological-feature model at full width through the
    Synthesizer on English text (g2p): attention_fwd launches, card against
    CPU in f32;
 21. vocoder training: the full-width HiFiGAN V1 against the default MPD +
    MSD through the ``train-vocoder`` CLI (B 16, 32-frame crops, bf16) on a
    seeded corpus of 32 harmonic tones of 1-4 s (``audio-22050.wav`` and
    spec), 40 steps with a checkpoint every 20: finite losses, mel L1 falling,
    no kernel launched; a SIGTERMed run after step 45, its resume to 50; then
    steps in bf16 and f32 in turns (wall; from a profiler trace the kernels'
    summed time, the card's busy time and the span), peak memory, the
    step's FLOPs and bound, a save's wall, a resume's load, parameters;
 22. card against CPU: one f32 D+G step (TF32 off) on B = 2 full crops from
    phase 21's last checkpoint: losses within 1e-4, G's and D's gradients
    within 1e-3 each;
 23. the trained vocoder: ``evaluate-vocoder`` on its vocoder.npz; the
    validation mels vocoded fused (MRF kernel, mrf_conv launches counted)
    and unfused in f32 within 5e-5; one Synthesizer request with it; the
    MRF stage raising under autograd before it launches;
 24. preprocessing: a seeded wav corpus (128 utterances of 1-11 s of
    harmonic tones with vibrato, silences and noise bursts; 16 stereo
    44.1 kHz files under sox effects; one of 12 s and one of 0.3 s that the
    length filter drops) through the ``preprocess`` CLI in a subprocess,
    on the host with 4 workers and with the spectral pass on the card: the
    filelists (the same split both times), one artifact of each kind an
    utterance, frame counts that agree, the card's spec and energy against
    the host's (the JAX package's tolerances, 2e-2 and 1e-1), stats.json
    and the normalization; each run's wall and utterances a second, the
    card's batch of 16 at the top bucket; then 4 train steps (bf16, B 16)
    on the host tree with the launches of phase 11;
 25. ``check-data`` in-process on that tree with its step=4/ scoring every
    utterance, the objective estimates and the thorough clipping count:
    a row and a score an utterance, the scores sorted, the launches around
    the run (attention_fwd 8, mas_width1 1, ctc_alpha 1 an utterance,
    nothing else), ms an utterance of forward, loss and the host; A (p 0),
    B and C's alpha chain against their plain versions on inputs the run
    gave them; a 2+2-layer f32 model scoring 8 utterances on the card and
    on the CPU (losses within 1e-4 relative, ``SharedBins``).
 26. the operator's tools: ``benchmark`` in-process on phase 11's config
    (the default model at full width, bf16, B 16) in training and inference
    mode, 5 warmup calls and 5 trials of 50: the printed line parsed, MFU in
    (0, 100 %], the launches around each run (8 attention_fwd and, in
    training mode, 1 mas_width1 a call, nothing else), A (p 0) and B against
    their plain versions on inputs the runs gave them, one run with
    ``--profile-dir`` whose trace's kernels are listed; one train step more
    on phase 11's run (keeping 3 checkpoints), then ``average-checkpoints --last 2`` and
    ``--use-ema`` on its step directories (parameters averaged, buffers the
    newest's), the EMA average served for one request; ``export-checkpoint``
    of it synthesizing the step directory's mel; ``doctor`` on phase 24's
    config exiting 0 with every kernel source built and loaded.
 27. exported serving: ``export-serving --platforms cuda`` through the CLI
    on phase 11's newest step=N/ and phase 5's HiFiGAN V1 at B 1 and 8, text
    buckets 48 and 128 (cut from the default sweep) and the 128-frame window
    (6 acoustic, 6 vocoder and 1 streaming program): its printed line, wall
    and size; the artifact through ``ExportedSynthesizer`` on the card
    (warmup runs all 13), 8 texts at B 8 and one at B 1 against the live
    Synthesizer of the same directory (durations equal, mels, the vocoder
    programs against the eager vocoder on their inputs, the wavs before the
    live path's vocoder edge), the launches around each run (8
    attention_fwd an acoustic program call, nothing else), A against its
    plain version on the inputs the exported program gave it (captured by a
    TorchDispatchMode); request times exported and live in turns, with and
    without the vocoder; ``serve model.fs2x`` answering a wav, a mel and a
    low_latency request over HTTP.
 28. YAML configs and TensorBoard media: phase 11's config written as YAML
    (a main file and a training partial, with block sequences, a folded
    string, an IPA escape, and ``training.vocoder_path`` relative to the
    file naming phase 21's vocoder.npz) equals phase 11's JSON config; the
    ``train`` CLI on it for 2 steps with a validation at step 2; its event
    file read back with ``read_events``: every scalar tag at the JAX
    cadence, the validation losses equal ``val_log.jsonl``'s, the attention
    and mel PNGs decoded to their sizes, ``pred/wav`` PCM16 at the vocoder's
    rate, the padded row's length, within one PCM16 step of the vocoder run
    again on the same mel; ``Trainer.validate(0, 0)`` for the step-0
    ``gt/`` and ``copy-synthesis/`` clips, checked alike; A, B and
    ``ctc_alpha`` launches equal in a validation with media and one
    without, ``mrf_conv`` 0; the two timed in turns (medians of 3), the
    event file's size, the CRC's MB/s and the YAML parse's ms.
 29. distributed training (``phase_distributed``): (i) ``python -m
    torch.distributed.run --nproc_per_node 1 -m fastspeech2_lightning_tpu_torch
    train --distributed`` over NCCL on phase 11's config for 8 steps, held to
    a one-process CLI run of that config: its grad norms, and tensor by
    tensor its first moments and its update since the initial weights,
    within 4 x what a second one-process run differs from the first (A'
    sums dQ with atomics), floored at the median of those distances, plus
    1e-4; its max-abs from phase 11's step=8/
    (Adam's bound beside it) and its ms a step beside phase 11's; (ii) two
    processes on the one card through ``parallel.launch.run_local`` over
    gloo, data=2, model=2 and data=2 with ZeRO-1, 4 steps of f32 at Noam
    rates 3.3e-5 to 1e-4 from phase 11's corpus each, held to a one-process
    f32 run (``_hold_f32``): at step=1/ the update, and the EMA's, tensor by
    tensor within rel-L2 1e-3 and the weights and EMA element by element
    within rtol 1e-5 / atol 1e-6, on the elements whose gradient is not
    zero to rounding (at most 10 % left out), the Adam moments and the
    first step's losses within rtol 1e-4 (the card sums a rank's rows in
    another order), each plus 4 x a second one-process run's spread; at
    step=4/ the grad norms, first moments and updates against one process
    reported beside that run's (the alignment search's choices drift runs
    apart after the first step); a ZeRO-1 run with a planted fault (its
    moments updated, its parameters left as they were) that the step=1/
    hold must refuse by its update; the launches on
    each rank a step (8 A, 8 A', 1 B, 1 ``ctc_alpha_beta``, 1 ``ctc_grad``),
    the peak memory with ZeRO-1 and without; (iii) A and A' at the dropout
    offsets those ranks pass, against their plain versions, and their masks
    read back bit for bit.
    The kernels' line gains these launches as ``distributed``.

f32 comparisons run with TF32 off. Wall times are medians of CUDA-event
timings of single calls (host time included where the call is shorter than
it); device times are per call of calls queued back to back behind a spin
kernel (``device_ms``). Prints a line for every check and timing, the
kernels' JSON line (with the trainer's timings), the card's name and power
limit, and last the result line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
import zipfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
PORT = "fastspeech2_lightning_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores
PEAK_BYTES = 3.35e12

SEED = 0
BATCH = 8
LETTERS = list("abcdefghijklmnopqrstuvwxyz")
WORDS = ("the a of and to in is was he for it with as his on be at by had are but from "
         "or have an they which one you were her all she there would their we him been "
         "has when who will more no if out so said what up its about into than them can "
         "only other new some could time these two may then do first any my now such like "
         "our over man me even most made after also did many before must through back "
         "years where much your way well down should because each just those people").split()


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of `iters` CUDA-event timings of fn() after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, iters: int = 20) -> float:
    """Milliseconds per call of fn() on the card alone, the host's time per
    call left out: `iters` calls are queued behind a spin kernel
    (torch.cuda._sleep), so they run back to back once it ends, between two
    CUDA events. The spin grows until the host has queued every call before
    the first one starts."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 25
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail(f"device_ms({getattr(fn, '__name__', fn)}): the card reached the timed calls before "
         f"the host had queued them")


def kernels_ms(fn, iters: int = 10):
    """Device ms per call of fn() as the sum of the kernel and copy times a
    torch.profiler trace records, for a call that waits on the host inside
    (which device_ms cannot queue); None when the trace holds no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def device_busy_ms(fn, iters: int = 2):
    """Per call of fn(), from a torch.profiler trace of `iters` calls: the
    sum of the kernels' times, the union of their intervals (the card busy)
    and the span from the first kernel's start to the last one's end, in
    ms; None when the trace holds no device event. 1 - busy / span is the
    card's idle share while calls follow each other."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return {"kernel_sum_ms": sum(b - a for a, b in spans) / 1e3 / iters,
            "busy_ms": busy / 1e3 / iters,
            "span_ms": (spans[-1][1] - spans[0][0]) / 1e3 / iters}


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def errors(got, want) -> tuple:
    import torch

    d = got.float() - want.float()
    max_abs = float(d.abs().max())
    rel = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(want.float()))
    return max_abs, rel


class SharedBins:
    """Holds the card's pitch and energy bucket choices against the CPU's
    in a card-against-CPU comparison, so that the mel is compared on the same
    discrete decisions. Inside ``with SharedBins() as bins:`` run the CPU
    first under ``with bins.on("cpu"):``: the variance adaptor's bucketize
    calls are recorded. Then run the card under ``bins.on("cuda")``, making the
    same calls in the same order: each one computes its own buckets and
    holds them against the CPU's. A bucket may differ only where the two
    predictions lie within EDGE of each other, i.e. on either side of a bin
    edge (the card and the CPU sum in different orders); anything else
    fails. The CPU's buckets are then used, so that the mel compares the
    continuous path alone. ``flips`` counts the buckets that differed."""

    EDGE = 1e-4

    def __init__(self):
        self.recorded, self.flips, self.calls, self.mode, self.pos = [], 0, 0, None, 0

    def __enter__(self):
        from fastspeech2_lightning_tpu_torch.models import variance_adaptor

        self._module, self._own = variance_adaptor, variance_adaptor.bucketize
        variance_adaptor.bucketize = self._bucketize
        return self

    def __exit__(self, *exc):
        self._module.bucketize = self._own

    @contextlib.contextmanager
    def on(self, dev: str):
        self.mode, self.pos = dev, 0
        try:
            yield self
        finally:
            self.mode = None

    def held(self) -> int:
        """Checks that the card made every call the CPU made; the flips."""
        check(self.calls > 0 and self.pos == len(self.recorded),
              f"the card made {self.pos} of the CPU's {len(self.recorded)} bucketize calls")
        return self.flips

    def _bucketize(self, values, boundaries):
        idx = self._own(values, boundaries)
        if self.mode is None:
            return idx
        if self.mode == "cpu":
            self.recorded.append((values.detach().clone(), idx.clone()))
            return idx
        check(self.pos < len(self.recorded), "the card made more bucketize calls than the CPU")
        v_cpu, i_cpu = self.recorded[self.pos]
        self.pos += 1
        self.calls += 1
        check(idx.shape == i_cpu.shape, f"bucketize shapes {tuple(idx.shape)} (card) and "
                                        f"{tuple(i_cpu.shape)} (CPU) differ")
        differ = idx.cpu() != i_cpu
        if bool(differ.any()):
            gap = float((values.detach().cpu() - v_cpu)[differ].abs().max())
            check(gap <= self.EDGE, f"{int(differ.sum())} pitch or energy bucket(s) differ "
                                    f"between card and CPU with predictions {gap} apart")
            self.flips += int(differ.sum())
        return i_cpu.to(idx.device)


# -- phase 1-2 ---------------------------------------------------------------


def phase_device() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {torch.cuda.device_count()} card(s)")
    return smi


def phase_build() -> None:
    from fastspeech2_lightning_tpu_torch.kernels import build

    t0 = time.time()
    names = build.all_sources()
    check(names == ["attention_bwd", "attention_fwd", "ctc_banded_lse", "mas_width1", "mrf_conv"],
          f"unexpected kernel sources {names}")
    logs = build.build(names)
    seconds = time.time() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            entry = re.search(r"entry function '(\S+)'", line)
            if entry:  # the mangled kernel name, without its file's anonymous namespace
                kernel = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", entry[1])
                log(f"build {name}: {kernel[:40]}")
            elif "Used" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")
    log(f"build: {names} in {seconds:.1f} s")


# -- phase 3: attention ------------------------------------------------------


def phase_attention() -> list:
    import torch
    import torch.nn.functional as F

    from fastspeech2_lightning_tpu_torch.ops.attention import (
        NEG_INF, attention_fwd, attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (B, H, T, dh), dtype, masked in (((8, 2, 1024, 128), torch.bfloat16, True),
                                         ((8, 2, 1024, 128), torch.bfloat16, False),
                                         ((8, 2, 1000, 128), torch.float32, True),
                                         ((8, 4, 160, 64), torch.float32, True)):
        q, k, v = (torch.randn(B, H, T, dh, device="cuda", generator=g).to(dtype)
                   for _ in range(3))
        lens = torch.linspace(T, T // 3, B, device="cuda").round().long()
        lens[1] = T - 37  # ragged, off any tile boundary
        if not masked:  # every key valid: no tile to skip
            lens[:] = T
        valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
        bias = torch.where(valid, 0.0, NEG_INF).float()
        scale = 1.0 / math.sqrt(dh)

        out = attention_fwd(q, k, v, bias, scale)
        torch.cuda.synchronize()
        want = attention_reference(q.float(), k.float(), v.float(), bias, scale)
        max_abs, rel = errors(out, want)
        limit = 1e-5 if dtype == torch.float32 else 2e-2
        check(rel <= limit, f"attention_fwd {B, H, T, dh} {dtype}: rel-L2 {rel} > {limit}")

        mask = bias[:, None, None, :].to(dtype)
        def kernel_fn():
            return attention_fwd(q, k, v, bias, scale)

        def library_fn():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        kernel, kernel_dev = time_ms(kernel_fn), device_ms(kernel_fn)
        plain = time_ms(lambda: attention_reference(q, k, v, bias, scale))
        library, library_dev = time_ms(library_fn), device_ms(library_fn)
        dt = str(dtype).split(".")[-1]
        flops = 4.0 * H * T * dh * float(lens.sum())  # keys the mask keeps
        nbytes = 4 * B * H * T * dh * q.element_size() + B * T * 4
        bound, bound_by = bound_ms(flops, nbytes, dt)
        row = dict(shape=[B, H, T, dh], dtype=dt, mask="ragged" if masked else "full",
                   max_abs_err=max_abs, rel_l2=rel, ms=kernel, device_ms=kernel_dev,
                   plain_ms=plain, library_ms=library, library_device_ms=library_dev,
                   bound_ms=bound, bound_by=bound_by)
        log(f"attention_fwd {B, H, T, dh} {dt} {row['mask']} mask: max_abs={max_abs:.3e} "
            f"rel_l2={rel:.3e} kernel_ms={kernel:.4f} (device {kernel_dev:.4f}) "
            f"plain_ms={plain:.4f} library_ms={library:.4f} (device {library_dev:.4f}) "
            f"bound_ms={bound:.4f} ({bound_by})")
        rows.append(row)
    return rows


# -- phase 4: MRF stage ------------------------------------------------------

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


def _stage_blocks(C: int, g) -> list:
    import torch

    blocks = []
    for k, dils in zip(KS, DILS):
        p = {}
        for i in range(len(dils)):
            for name in ("convs1", "convs2"):
                p[f"{name}.{i}.weight"] = (torch.randn(C, C, k, device="cuda", generator=g)
                                           / math.sqrt(k * C))
                p[f"{name}.{i}.bias"] = 0.1 * torch.randn(C, device="cuda", generator=g)
        blocks.append(p)
    return blocks


# f32 inputs are multiplied as pairs of bf16 parts (a_hi w_hi + a_lo w_hi +
# a_hi w_lo; a_lo w_lo, 2^-16 of the sum, is dropped), so a conv keeps about
# 16 bits of each factor: the stage is held to 5e-5 against the f32 plain
# version with TF32 off, not to the 1e-5 of an f32 FMA kernel (measured on an
# H100: 3.8e-6 to 5.5e-6 a stage).
MRF_LIMIT = {"float32": 5e-5, "bfloat16": 2e-2}
MRF_LAUNCHES = 2 * len(KS) * len(DILS[0])  # per stage: one per conv


def phase_mrf(batch: int = BATCH, frames: int = 256, dtypes=("bfloat16", "float32")) -> list:
    """Rows for C = 128, 64, 32 x `dtypes`, in that order: the V1 vocoder's
    fused stages for `batch` mels of `frames` frames."""
    import torch

    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import (
        fused_mrf_stage, mrf_stage_reference, prepare_stage_weights,
    )

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for C, T in ((128, frames * 64), (64, frames * 128), (32, frames * 256)):
        blocks = _stage_blocks(C, g)
        x32 = torch.randn(batch, T, C, device="cuda", generator=g)
        for dtype in (getattr(torch, d) for d in dtypes):
            dt = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            flat = prepare_stage_weights(blocks, KS, DILS, dtype)
            out = fused_mrf_stage(x, flat, KS, DILS)
            torch.cuda.synchronize()
            ref_blocks = [{n: w.to(dtype).float() for n, w in p.items()} for p in blocks]
            want = mrf_stage_reference(x.float(), ref_blocks, KS, DILS)
            max_abs, rel = errors(out, want)
            check(rel <= MRF_LIMIT[dt], f"mrf stage C={C} {dt}: rel-L2 {rel} > {MRF_LIMIT[dt]}")
            del out, want

            typed_blocks = [{n: w.to(dtype) for n, w in p.items()} for p in blocks]

            def kernel_fn():
                return fused_mrf_stage(x, flat, KS, DILS)

            def plain_fn():
                return mrf_stage_reference(x, typed_blocks, KS, DILS)

            # 10 stages are 180 launches: well inside CUDA's launch queue, which
            # the plain version's hundreds of small kernels would fill
            kernel, kernel_dev = time_ms(kernel_fn), device_ms(kernel_fn, iters=10)
            plain = time_ms(plain_fn, iters=10)
            # every product runs on the bf16 tensor cores: one per
            # multiply-add for bf16 inputs, three (the bf16 pairs) for f32
            products = 3 if dtype == torch.float32 else 1
            flops = products * 2.0 * batch * T * C * C * 2 * sum(KS) * len(DILS[0])
            nbytes = (2 * batch * T * C * x.element_size()
                      + sum(t.numel() * t.element_size() for t in flat))
            bound, bound_by = bound_ms(flops, nbytes, "bfloat16")
            row = dict(shape=[batch, T, C], dtype=dt, launches_per_stage=MRF_LAUNCHES,
                       max_abs_err=max_abs, rel_l2=rel, ms=kernel, device_ms=kernel_dev,
                       plain_ms=plain, library_ms=None,
                       bound_ms=bound, bound_by=bound_by,
                       bound_counts=f"{products} bf16 tensor-core product(s) per multiply-add")
            log(f"mrf stage [B={batch}, T={T}, C={C}] {dt}: max_abs={max_abs:.3e} "
                f"rel_l2={rel:.3e} kernel_ms={kernel:.3f} (device {kernel_dev:.3f}) "
                f"plain_ms={plain:.3f} bound_ms={bound:.3f} "
                f"({bound_by}, {row['bound_counts']})")
            rows.append(row)
        del x32
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return rows


# -- phase 5: serving --------------------------------------------------------


def model_config(dtype: str) -> dict:
    """The default config (full width and depth) with a character inventory."""
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config

    cfg = FastSpeech2Config().to_dict()
    cfg["model"]["dtype"] = dtype
    cfg["text"]["symbols"] = {"letters": LETTERS}
    return cfg


STATS = {
    "pitch": dict(min=50.0, max=400.0, std=40.0, mean=150.0, norm_min=-2.5, norm_max=6.0),
    "energy": dict(min=0.0, max=90.0, std=12.0, mean=30.0, norm_min=-2.5, norm_max=5.0),
    "character_length": dict(min=10.0, max=160.0, std=30.0, mean=80.0, norm_min=10.0,
                             norm_max=160.0),
}


def random_state_dict(cfg: dict, rng) -> dict:
    """Seeded weights for every entry of the port's FastSpeech2 state_dict:
    fan-in scaled normals, BatchNorm statistics near (0, 1), the checkpoint's
    bin boundaries from the stats, and a duration head that gives about 6
    frames a symbol."""
    import numpy as np

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.text import TextProcessor

    config = FastSpeech2Config.from_dict(cfg)
    n_symbols = len(TextProcessor(config.text).symbols)
    model = FastSpeech2(config, n_symbols=n_symbols)
    vp = config.model.variance_predictors
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked") or name.endswith("inv_freq"):
            sd[name] = t.numpy()
        elif name.endswith("running_var"):
            sd[name] = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean"):
            sd[name] = 0.1 * rng.standard_normal(shape)
        elif name.endswith("_bins"):
            kind = name.split(".")[-1].split("_")[0]
            st, n_bins = STATS[kind], getattr(vp, kind).n_bins
            sd[name] = np.linspace(st["norm_min"], st["norm_max"], n_bins - 1)
        elif name == "variance_adaptor.duration_predictor.linear.bias":
            sd[name] = np.full(shape, math.log(7.0))
        elif name == "variance_adaptor.duration_predictor.linear.weight":
            sd[name] = 0.3 * rng.standard_normal(shape) / math.sqrt(shape[1])
        elif len(shape) == 1:
            base = 1.0 if name.endswith(".weight") else 0.0
            sd[name] = base + 0.1 * rng.standard_normal(shape)
        elif "embedding" in name or name == "text_input_layer.weight":
            sd[name] = rng.standard_normal(shape)
        else:
            sd[name] = rng.standard_normal(shape) / math.sqrt(int(np.prod(shape[1:])))
        if sd[name].dtype == np.float64:
            sd[name] = sd[name].astype(np.float32)
    return sd


def random_hifigan_npz(path: Path, rng) -> None:
    """A seeded HiFiGAN V1 generator (upsample_initial_channel 512) as an
    .npz of the JAX package's parameter pytree: convs [K, Cin, Cout]."""
    import numpy as np

    from fastspeech2_lightning_tpu_torch.models.hifigan import HiFiGANConfig

    cfg = HiFiGANConfig()

    def conv(k, cin, cout, gain=2.0):
        return (rng.standard_normal((k, cin, cout)) * math.sqrt(gain / (k * cin))).astype(
            np.float32)

    p = {"conv_pre_w": conv(7, cfg.n_mels, cfg.upsample_initial_channel, 1.0),
         "conv_pre_b": np.zeros(cfg.upsample_initial_channel, np.float32)}
    ch = cfg.upsample_initial_channel
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cout = ch // 2
        p[f"up_{i}_w"] = conv(k, ch, cout, 2.0 * u)
        p[f"up_{i}_b"] = np.zeros(cout, np.float32)
        for j, (rk, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
            block = {}
            for di in range(len(dils)):
                for name in ("convs1", "convs2"):
                    block[f"{name}_{di}_w"] = conv(rk, cout, cout, 0.5)
                    block[f"{name}_{di}_b"] = np.zeros(cout, np.float32)
            p[f"res_{i}_{j}"] = block
        ch = cout
    p["conv_post_w"] = conv(7, ch, 1, 1.0)
    p["conv_post_b"] = np.zeros(1, np.float32)
    np.savez(path, params=np.array(p, dtype=object),
             config=np.array(dataclasses.asdict(cfg), dtype=object), global_step=0)


def request_texts(rng) -> list:
    texts = []
    for n in (60, 100, 150, 200, 250, 300, 350, 400):
        words = []
        while len(" ".join(words)) < n:
            w = str(rng.choice(WORDS))
            if rng.random() < 0.12:
                w += str(rng.choice([",", ".", "?", "!", ";"]))
            words.append(w)
        texts.append(" ".join(words)[:n].strip() + ".")
    return texts


def _post(address, payload: dict):
    host, port = address[:2]
    req = urllib.request.Request(f"http://{host}:{port}/synthesize",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = r.read()
        return r.status, body, time.time() - t0


def _get(address, path: str):
    host, port = address[:2]
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as r:
        return r.status, json.loads(r.read())


def vocoder_share(syn, stages: list) -> dict:
    """Device ms of the vocoder alone on the largest batch it served (random
    mel of that shape), and of that batch's fused MRF stages alone (random
    weights, the served dtype): how much of the vocoder the kernel is."""
    import torch

    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import (
        fused_mrf_stage, prepare_stage_weights,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    hop = syn.vocoder.hop
    (B, T, _), dtype_name = max(stages, key=lambda s: s[0][1])  # the full-rate stage
    dtype = getattr(torch, dtype_name.split(".")[-1])
    frames = T // hop
    mel = torch.randn(B, frames, syn.config.preprocessing.audio.n_mels, device="cuda",
                      generator=g)
    whole = device_ms(lambda: syn.vocoder.device_fn(mel), iters=3)
    by_stage = {}
    for shape in sorted({s[0] for s in stages if s[0][1] * s[0][2] == T * 32}):
        C = shape[2]
        x = torch.randn(*shape, device="cuda", generator=g).to(dtype)
        flat = prepare_stage_weights(_stage_blocks(C, g), KS, DILS, dtype)
        by_stage[C] = device_ms(lambda: fused_mrf_stage(x, flat, KS, DILS), iters=5)
        del x
    mrf = sum(by_stage.values())
    log(f"vocoder alone at the largest served batch [{B}, {frames} frames] {dtype_name}: "
        f"device {whole:.2f} ms, of which the fused MRF stages {mrf:.2f} ms ("
        + ", ".join(f"C={C}: {ms:.2f}" for C, ms in sorted(by_stage.items(), reverse=True))
        + f"): {mrf / whole:.0%}")
    return dict(shape=[B, frames], dtype=dtype_name, vocoder_device_ms=whole,
                mrf_stages_device_ms=mrf)


def phase_serving(workdir: Path, sd: dict, cfg: dict) -> dict:
    """Serve 8 concurrent requests and check them; returns each kernel's
    launch count during the requests, and under "vocoder" the device time of
    the vocoder alone beside its MRF stages' (``vocoder_share``)."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint
    from fastspeech2_lightning_tpu_torch.models import hifigan
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd
    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import mrf_conv
    from fastspeech2_lightning_tpu_torch.serving import serve
    from fastspeech2_lightning_tpu_torch.synthesis.prepare import chunk_text_for_model

    rng = np.random.default_rng(SEED + 2)
    ckpt = write_checkpoint(workdir / "model.ckpt", sd, cfg, STATS)
    voc = workdir / "hifigan_v1.npz"
    random_hifigan_npz(voc, rng)
    t0 = time.time()
    server = serve(ckpt, vocoder_path=voc, port=0, max_batch=BATCH, vocoder_fused=True,
                   warmup=True)
    load_s = time.time() - t0
    syn = server.synthesizer
    check(syn.device.type == "cuda", f"serve() chose {syn.device}")
    hop = syn.vocoder.hop

    # frames of every chunk the batcher synthesized, to check each wav's
    # length, and whether every float waveform was finite before PCM16
    frames = {}
    finite = []
    synthesize = syn.synthesize

    def recording(texts, **kwargs):
        result = synthesize(texts, **kwargs)
        for text, mel in zip(texts, result.mels):
            frames.setdefault(text, mel.shape[0])
        finite.extend(bool(np.isfinite(w).all()) for w in result.wavs)
        return result

    syn.synthesize = recording
    stages = []  # one entry for every MRF stage the vocoder ran fused
    run_stage = hifigan.fused_mrf_stage

    def counting_stage(x, *args):
        stages.append((tuple(x.shape), str(x.dtype)))
        return run_stage(x, *args)

    hifigan.fused_mrf_stage = counting_stage
    texts = request_texts(rng)
    attention_fwd.launches = 0
    mrf_conv.launches = 0
    server.start()
    try:
        t0 = time.time()
        with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
            futures = [pool.submit(_post, server.address,
                                   {"text": t, "format": "wav" if i % 2 == 0 else "mel"})
                       for i, t in enumerate(texts)]
            responses = [f.result() for f in futures]
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"attention_fwd": attention_fwd.launches, "mrf_conv": mrf_conv.launches}
        _, health = _get(server.address, "/health")
        _, stats = _get(server.address, "/stats")
    finally:
        server.shutdown()
        hifigan.fused_mrf_stage = run_stage

    for i, (text, (status, body, seconds)) in enumerate(zip(texts, responses)):
        fmt = "wav" if i % 2 == 0 else "mel"
        check(status == 200, f"request {i} ({fmt}) answered {status}")
        chunks = chunk_text_for_model(text, None, syn.config, syn.stats)
        want_frames = sum(frames[c] for c in chunks)
        if fmt == "wav":
            check(body[:4] == b"RIFF" and body[8:12] == b"WAVE" and body[36:40] == b"data",
                  f"request {i}: no RIFF/WAVE header")
            rate = struct.unpack("<I", body[24:28])[0]
            check(rate == syn.vocoder.sample_rate, f"request {i}: sample rate {rate}")
            pcm = np.frombuffer(body[44:], dtype="<i2")
            check(pcm.size == want_frames * hop,
                  f"request {i}: {pcm.size} samples for {want_frames} frames x {hop}")
            check(int(pcm.max()) != int(pcm.min()), f"request {i}: constant audio")
        else:
            mel = np.load(io.BytesIO(body))
            check(mel.shape == (want_frames, syn.config.preprocessing.audio.n_mels),
                  f"request {i}: mel {mel.shape}, want {want_frames} frames")
            check(bool(np.isfinite(mel).all()) and float(mel.std()) > 0,
                  f"request {i}: mel not finite or constant")
        log(f"request {i}: {fmt} {len(text)} chars, {len(chunks)} chunks, {want_frames} "
            f"frames -> 200 in {seconds:.3f} s")
    check(all(finite), "a synthesized waveform was not finite")
    check(health.get("status") == "ok", f"/health {health}")
    check(stats.get("batches_dispatched", 0) > 0, f"/stats counted no batches: {stats}")
    check(stats.get("batch_errors", 0) == 0, f"/stats counted batch errors: {stats}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched while serving")
    check(launches["mrf_conv"] == MRF_LAUNCHES * len(stages),
          f"mrf_conv launched {launches['mrf_conv']} times for {len(stages)} fused stages")
    log(f"serving: {len(texts)} concurrent requests in {wall:.3f} s (server load + warmup "
        f"{load_s:.1f} s); batches {stats['batches_dispatched']}, batch_ms {stats.get('batch_ms')}; "
        f"launches {launches}; fused MRF stages ([B, T, C], dtype): {sorted(set(stages))}, "
        f"{len(stages)} in all")
    launches["vocoder"] = vocoder_share(syn, stages)
    return launches


# -- phase 6: card against CPU ----------------------------------------------


def phase_card_vs_cpu(sd: dict) -> None:
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.dataset import PAD_MULT_TEXT, _round_up
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.synthesis.prepare import encode_texts_for_model
    from fastspeech2_lightning_tpu_torch.text import TextProcessor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = FastSpeech2Config.from_dict(model_config("float32"))
    tp = TextProcessor(config.text)
    texts = request_texts(np.random.default_rng(SEED + 3))[:2]
    encoded, _ = encode_texts_for_model(texts, None, config, tp, {})
    L = _round_up(max(len(e) for e in encoded), PAD_MULT_TEXT)
    text = np.zeros((len(encoded), L), np.int64)
    for i, e in enumerate(encoded):
        text[i, : len(e)] = e
    lens = np.array([len(e) for e in encoded])
    T = min(config.model.max_mel_length, _round_up(12 * L, 128))
    outs = {}
    with SharedBins() as bins:
        for dev in ("cpu", "cuda"):
            model = FastSpeech2(config, n_symbols=len(tp.symbols))
            model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
            model = model.to(dev).eval()
            with torch.no_grad(), bins.on(dev):
                out = model(torch.as_tensor(text, device=dev), torch.as_tensor(lens, device=dev),
                            T)
            outs[dev] = {k: v.cpu() for k, v in out.items() if v is not None}
    gpu, cpu = outs["cuda"], outs["cpu"]
    check(torch.equal(gpu["duration_rounded"], cpu["duration_rounded"]),
          "duration_rounded differs between card and CPU")
    check(int(cpu["tgt_lens"].min()) > 0, "the f32 batch predicted no frames")
    mel_err = float((gpu["postnet_output"] - cpu["postnet_output"]).abs().max())
    check(mel_err <= 1e-3, f"card vs CPU mel max-abs {mel_err} > 1e-3")
    log(f"card vs CPU (f32, TF32 off): durations equal, frames {cpu['tgt_lens'].tolist()}, "
        f"mel max-abs {mel_err:.3e}; pitch and energy buckets differing at an edge "
        f"{bins.held()}")


# -- phases 7-8: training attention (kernels A and A') ----------------------

TRAIN_SHAPES = ((16, 2, 1024, 128), (16, 2, 2048, 128))
DROPOUT_P = (0.0, 0.2)


def _ragged_bias(B, T, g):
    """[B, T] key bias: lengths drawn from [T/3, T], item 0 full, item 1
    T - 37, item 2 with no valid key, item 3 with a hole of a quarter of its
    length in the middle; and [B] the keys each item's attention needs (all
    T for item 2, whose rows average every key)."""
    import torch

    from fastspeech2_lightning_tpu_torch.ops.attention import NEG_INF

    lens = torch.randint(T // 3, T + 1, (B,), device="cuda", generator=g)
    lens[0], lens[1], lens[2] = T, T - 37, 0
    valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
    quarter = int(lens[3]) // 4
    valid[3, quarter:2 * quarter] = False
    needed = torch.where(valid.any(1), valid.sum(1), T)
    return torch.where(valid, 0.0, NEG_INF).float(), needed


def phase_attention_train() -> None:
    """Kernels A (forward with dropout and log-sum-exp) and A' (backward)
    against the plain version in f32 on the same bf16-rounded inputs, with
    the same seed, so the same mask, on masks with the edge cases (phase 13
    times them on the training buckets' own masks)."""
    import torch
    import torch.nn.functional as F

    from fastspeech2_lightning_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_reference, attention_dropout_reference, attention_fwd,
        dropout_keep_mask,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    seed = torch.tensor([123457], dtype=torch.int32, device="cuda")
    for B, H, T, dh in TRAIN_SHAPES:
        bias, needed = _ragged_bias(B, T, g)
        q32, k32, v32, do32 = (torch.randn(B, H, T, dh, device="cuda", generator=g)
                               for _ in range(4))
        scale = 1.0 / math.sqrt(dh)
        for p in DROPOUT_P:
            if p > 0:
                keep = dropout_keep_mask(int(seed), B, H, T, p, device="cuda")
                kept, n = int(keep.sum()), keep.numel()
                sigma = math.sqrt(n * p * (1 - p))
                check(abs(kept - n * (1 - p)) <= 5 * sigma,
                      f"kept share {kept / n:.6f} not within 5 sigma of {1 - p}")
                del keep
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
                dt = str(dtype).split(".")[-1]
                out, lse = attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)
                grads = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)
                torch.cuda.synchronize()
                qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
                want = attention_dropout_reference(qf, kf, vf, bias, seed, p, scale)
                f_abs, f_rel = errors(out, want)
                del want
                want_grads = attention_bwd_reference(qf, kf, vf, bias, seed, p, scale, dof)
                b_errs = [errors(gt, wt) for gt, wt in zip(grads, want_grads)]
                del want_grads
                limit = 1e-5 if dtype == torch.float32 else 2e-2
                check(f_rel <= limit, f"attention_fwd {B, H, T, dh} {dt} p={p}: rel-L2 {f_rel}")
                for name, (_, rel) in zip(("dQ", "dK", "dV"), b_errs):
                    check(rel <= limit, f"attention_bwd {name} {B, H, T, dh} {dt} p={p}: "
                                        f"rel-L2 {rel} > {limit}")

                mask = bias[:, None, None, :].to(dtype)
                fwd_ms = time_ms(lambda: attention_fwd(q, k, v, bias, scale, p=p, seed=seed,
                                                       with_lse=True), iters=10)
                bwd_ms = time_ms(lambda: attention_bwd(q, k, v, bias, seed, p, scale, out, lse,
                                                       do), iters=10)
                fwd_plain = time_ms(lambda: attention_dropout_reference(
                    q, k, v, bias, seed, p, scale), warmup=1, iters=3)
                bwd_plain = time_ms(lambda: attention_bwd_reference(
                    q, k, v, bias, seed, p, scale, do), warmup=1, iters=3)
                fwd_lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, dropout_p=p, scale=scale), iters=10)
                qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

                def sdpa_fwd_bwd():
                    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                       dropout_p=p, scale=scale)
                    torch.autograd.grad(o, (qg, kg, vg), do)

                bwd_lib = time_ms(sdpa_fwd_bwd, iters=10)
                # the backward alone, like for like with kernel A': one graph, its
                # backward run again and again (the same dropout mask each time)
                o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, dropout_p=p,
                                                       scale=scale)
                bwd_lib_only = time_ms(lambda: torch.autograd.grad(
                    o_lib, (qg, kg, vg), do, retain_graph=True), iters=10)
                dev = {}
                if dtype == torch.bfloat16:  # the kernels alone, host time out
                    dev = dict(
                        fwd=device_ms(lambda: attention_fwd(q, k, v, bias, scale, p=p, seed=seed,
                                                            with_lse=True)),
                        bwd=device_ms(lambda: attention_bwd(q, k, v, bias, seed, p, scale, out,
                                                            lse, do)),
                        fwd_lib=device_ms(lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, dropout_p=p, scale=scale)),
                        bwd_lib=device_ms(lambda: torch.autograd.grad(
                            o_lib, (qg, kg, vg), do, retain_graph=True)))
                    log(f"attention {B, H, T, dh} {dt} p={p} device ms: A {dev['fwd']:.4f}, "
                        f"SDPA {dev['fwd_lib']:.4f}; A' {dev['bwd']:.4f}, SDPA backward "
                        f"{dev['bwd_lib']:.4f}")
                del o_lib
                keys = float(needed.sum()) * H * T * dh  # query rows x needed keys x dh
                f_bound = bound_ms(4.0 * keys, (4 * B * H * T * dh) * q.element_size()
                                   + B * T * 4 + B * H * T * 4, dt)
                b_bound = bound_ms(10.0 * keys, (8 * B * H * T * dh) * q.element_size()
                                   + B * T * 4 + 2 * B * H * T * 4, dt)
                full = B * H * T * T * dh  # every key, masked ones included
                log(f"attention_fwd+dropout {B, H, T, dh} {dt} p={p}: max_abs={f_abs:.3e} "
                    f"rel_l2={f_rel:.3e} kernel_ms={fwd_ms:.4f} plain_ms={fwd_plain:.4f} "
                    f"library_ms={fwd_lib:.4f} bound_ms={f_bound[0]:.4f} ({f_bound[1]}; "
                    f"4BHT^2dh = {4 * full:.3e} FLOP)")
                log(f"attention_bwd {B, H, T, dh} {dt} p={p}: max_abs dQ/dK/dV="
                    f"{'/'.join(f'{e[0]:.3e}' for e in b_errs)} rel_l2="
                    f"{'/'.join(f'{e[1]:.3e}' for e in b_errs)} kernel_ms={bwd_ms:.4f} "
                    f"plain_ms={bwd_plain:.4f} library_bwd_ms={bwd_lib_only:.4f} (SDPA backward "
                    f"alone) library_fwd_bwd_ms={bwd_lib:.4f} (SDPA fwd+bwd) "
                    f"bound_ms={b_bound[0]:.4f} ({b_bound[1]}; 10BHT^2dh = {10 * full:.3e} FLOP)")
                del out, lse, grads
        torch.cuda.empty_cache()


# -- phase 13: kernels A and A' on the training buckets' masks ---------------


def _bucket_lengths(workdir: Path) -> list:
    """[(T, [B] mel lengths, L, [B] text lengths)] of each length bucket
    that the trainer's loader cuts from the smoke corpus (phase 11): the
    decoder attention's key masks and CTC's lengths in training. A bucket of
    fewer than B utterances is filled from its own, as the loader fills
    it."""
    import numpy as np

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, FastSpeechDataset
    from fastspeech2_lightning_tpu_torch.text.lookups import load_filelist

    config = FastSpeech2Config.from_file(workdir / "config.json")
    tcfg = config.training
    ds = FastSpeechDataset(load_filelist(tcfg.training_filelist), config, {"default": 0},
                           {"default": 0})
    loader = BucketedLoader(ds, tcfg.batch_size, n_buckets=tcfg.bucket_count,
                            max_mel_length=config.model.max_mel_length)
    return [(b.max_mel, np.resize(loader.mel_lens[b.indices], tcfg.batch_size), b.max_text,
             np.resize(loader.text_lens[b.indices], tcfg.batch_size)) for b in loader.buckets]


def _skipped_share(ends, T: int, tile: int) -> float:
    """The share of a kernel's key tiles of `tile` keys that lie at or past
    kv_end, which it skips."""
    tiles = -(-T // tile)
    return 1.0 - float((-(-ends // tile)).sum()) / (len(ends) * tiles)


def phase_attention_buckets(workdir: Path) -> dict:
    """Kernels A (forward with dropout and log-sum-exp) and A' (backward) at
    the decoder's training shape of each bucket the trainer cuts, (16, 2,
    T, 128) bf16 as fused views, p = 0 and 0.2: on the bucket's own key mask
    and on a full mask (nothing to skip). Each against the plain version;
    wall and device ms of both kernels and of SDPA (forward, backward alone);
    the share of key tiles each kernel skips. Returns the rows at the top
    bucket with its own mask, p = 0.2."""
    import torch
    import torch.nn.functional as F

    from fastspeech2_lightning_tpu_torch.ops.attention import (
        NEG_INF, attention_bwd, attention_bwd_reference, attention_dropout_reference,
        attention_fwd, kv_end,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    seed = torch.tensor([98765], dtype=torch.int32, device="cuda")
    H, dh = 2, 128
    keep_rows = {}
    for T, lens, _, _ in _bucket_lengths(workdir):
        B = len(lens)
        qkv = torch.randn(B, T, 3, H, dh, device="cuda", generator=g).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.randn(B, H, T, dh, device="cuda", generator=g).to(torch.bfloat16)
        scale = 1.0 / math.sqrt(dh)
        for mask_kind in ("bucket", "full"):
            n = torch.as_tensor(lens if mask_kind == "bucket" else [T] * B, device="cuda")
            bias = torch.where(torch.arange(T, device="cuda")[None] < n[:, None], 0.0,
                               NEG_INF).float()
            ends = kv_end(bias).long()
            fwd_skip, bwd_skip = _skipped_share(ends, T, 64), _skipped_share(ends, T, 128)
            mask = bias[:, None, None, :].to(torch.bfloat16)
            for p in DROPOUT_P:
                out, lse = attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)
                grads = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)
                torch.cuda.synchronize()
                qf, kf, vf = q.float(), k.float(), v.float()
                f_abs, f_rel = errors(out, attention_dropout_reference(qf, kf, vf, bias, seed,
                                                                       p, scale))
                b_errs = [errors(gt, wt) for gt, wt in zip(
                    grads, attention_bwd_reference(qf, kf, vf, bias, seed, p, scale, do.float()))]
                del qf, kf, vf
                check(max([f_rel] + [e[1] for e in b_errs]) <= 2e-2,
                      f"attention {B, H, T, dh} {mask_kind} mask p={p}: rel-L2 {f_rel}, "
                      f"{[e[1] for e in b_errs]} > 2e-2")

                def fwd():
                    return attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)

                def bwd():
                    return attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)

                def fwd_lib():
                    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p,
                                                          scale=scale)

                qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
                o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, dropout_p=p,
                                                       scale=scale)

                def bwd_lib():
                    return torch.autograd.grad(o_lib, (qg, kg, vg), do, retain_graph=True)

                def fwd_bwd_lib():
                    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, dropout_p=p,
                                                       scale=scale)
                    return torch.autograd.grad(o, (qg, kg, vg), do)

                ms = {name: (time_ms(fn, iters=10), device_ms(fn)) for name, fn in
                      (("fwd", fwd), ("bwd", bwd), ("fwd_lib", fwd_lib), ("bwd_lib", bwd_lib),
                       ("fwd_bwd_lib", fwd_bwd_lib))}
                del o_lib, qg, kg, vg
                fwd_plain = time_ms(lambda: attention_dropout_reference(
                    q, k, v, bias, seed, p, scale), warmup=1, iters=3)
                bwd_plain = time_ms(lambda: attention_bwd_reference(
                    q, k, v, bias, seed, p, scale, do), warmup=1, iters=3)
                keys = float(torch.where(n > 0, n, T).sum()) * H * T * dh
                f_bound = bound_ms(4.0 * keys, 4 * B * H * T * dh * 2 + B * T * 4 + B * H * T * 4,
                                   "bfloat16")
                b_bound = bound_ms(10.0 * keys, 8 * B * H * T * dh * 2 + B * T * 4
                                   + 2 * B * H * T * 4, "bfloat16")
                log(f"attention bucket T={T} {mask_kind} mask p={p}: lengths "
                    f"{int(n.min())}-{int(n.max())}, key tiles skipped A {fwd_skip:.1%} "
                    f"A' {bwd_skip:.1%}; rel_l2 {f_rel:.2e} / "
                    f"{'/'.join(f'{e[1]:.2e}' for e in b_errs)}; ms wall (device): "
                    + ", ".join(f"{name} {w:.4f} ({d:.4f})" for name, (w, d) in ms.items())
                    + f"; plain A {fwd_plain:.3f}, A' {bwd_plain:.3f}; bound A "
                    f"{f_bound[0]:.4f}, A' {b_bound[0]:.4f}")
                if mask_kind == "bucket" and p == 0.2:  # the last bucket is the top one
                    common = dict(shape=[B, H, T, dh], dtype="bfloat16", p=p,
                                  mask="the bucket's mel lengths")
                    keep_rows = dict(
                        fwd=dict(common, max_abs_err=f_abs, rel_l2=f_rel, ms=ms["fwd"][0],
                                 device_ms=ms["fwd"][1], plain_ms=fwd_plain,
                                 library_ms=ms["fwd_lib"][0], library_device_ms=ms["fwd_lib"][1],
                                 bound_ms=f_bound[0], bound_by=f_bound[1],
                                 skipped_tile_share=fwd_skip),
                        bwd=dict(common, max_abs_err=max(e[0] for e in b_errs),
                                 rel_l2=max(e[1] for e in b_errs), ms=ms["bwd"][0],
                                 device_ms=ms["bwd"][1], plain_ms=bwd_plain,
                                 library_ms=ms["bwd_lib"][0], library_device_ms=ms["bwd_lib"][1],
                                 library_fwd_bwd_ms=ms["fwd_bwd_lib"][0],
                                 bound_ms=b_bound[0], bound_by=b_bound[1],
                                 skipped_tile_share=bwd_skip))
                del out, lse, grads
        del qkv, q, k, v, do
        torch.cuda.empty_cache()
    return keep_rows


# -- phase 9: MAS (kernel B) -------------------------------------------------


def phase_mas() -> dict:
    """The row at (16, 2048, 1000), with the training corpus's top bucket
    (16, 2016, 192) beside it as `training_shape`."""
    import torch

    from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {}
    B = 16
    for T, L in ((1024, 160), (1024, 1000), (2048, 160), (2048, 1000), (2016, 192)):
        la = torch.log_softmax(torch.randn(B, T, L, device="cuda", generator=g), -1)
        in_lens = torch.randint(max(L // 4, 1), L + 1, (B,), device="cuda", generator=g)
        out_lens = torch.randint(T // 4, T + 1, (B,), device="cuda", generator=g)
        in_lens[0], out_lens[0] = L, T
        hard, dur = mas_width1(la, in_lens, out_lens)
        torch.cuda.synchronize()
        want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
        check(torch.equal(hard, want_hard) and torch.equal(dur, want_dur),
              f"mas_width1 B={B} T={T} L={L}: path differs from the plain version")
        check(torch.equal(dur.sum(1), out_lens.int()), "mas durations do not sum to out_lens")
        del hard, dur, want_hard, want_dur

        def kernel_fn():
            return mas_width1(la, in_lens, out_lens)

        kernel, kernel_dev = time_ms(kernel_fn, iters=10), device_ms(kernel_fn)
        plain = time_ms(lambda: mas_width1_reference(la, in_lens, out_lens), warmup=1,
                        iters=2)
        # bytes these lengths need: the valid part of log_attn read once,
        # both outputs written once whole (the zeros too)
        nbytes = 4 * (int((in_lens * out_lens).sum()) + B * T * L + B * L)
        bound = bound_ms(0.0, nbytes, "float32")
        log(f"mas_width1 B={B} T={T} L={L}: bit-exact, kernel_ms={kernel:.4f} "
            f"(device {kernel_dev:.4f}) plain_ms={plain:.2f} bound_ms={bound[0]:.4f} "
            f"({bound[1]})")
        rows[T, L] = dict(shape=[B, T, L], dtype="float32", max_abs_err=0.0, ms=kernel,
                          device_ms=kernel_dev, plain_ms=plain, library_ms=None,
                          bound_ms=bound[0], bound_by=bound[1])
    return dict(rows[2048, 1000], training_shape=rows[2016, 192])


# -- phase 10: CTC (kernel C) ------------------------------------------------


def ctc_case(B, T, L, in_lens, out_lens, seed: int) -> dict:
    """Kernel C at one shape against its plain version, on log-probabilities
    made as attention_ctc_loss makes them: the gradient-free forward
    (ctc_alpha), the forward with both chains (ctc_alpha_beta) and the
    backward (ctc_grad). Wall and device ms of each, of their plain versions
    and of F.ctc_loss (forward, and forward + backward); the bound of each
    launch from the bytes these lengths need."""
    import torch
    import torch.nn.functional as F

    from fastspeech2_lightning_tpu_torch.ops import ctc

    g = torch.Generator(device="cuda").manual_seed(seed)
    S = 2 * L + 1
    in_lens = torch.as_tensor(in_lens, device="cuda").long()
    out_lens = torch.as_tensor(out_lens, device="cuda").long()
    attn = torch.randn(B, T, L, device="cuda", generator=g)
    logits = torch.cat([torch.full((B, T, 1), -1.0, device="cuda"), attn], -1)
    lp = torch.log_softmax(torch.where(torch.arange(L + 1, device="cuda") > in_lens[:, None, None],
                                       ctc.NEG_INF, logits), -1)
    del attn, logits
    gvec = torch.rand(B, device="cuda", generator=g)

    alphas_only = ctc.ctc_alpha(lp, out_lens)
    alphas, betas = ctc.ctc_alpha_beta(lp, in_lens, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    grad = ctc.ctc_grad(alphas, betas, out_lens, ll, gvec)
    torch.cuda.synchronize()
    want_alphas = ctc.ctc_alpha_reference(lp, out_lens)
    want_betas = ctc.ctc_beta_reference(lp, in_lens, out_lens)
    want_ll = ctc._final_ll(want_alphas[:, -1], in_lens)
    want_grad = ctc.ctc_grad_reference(want_alphas, want_betas, out_lens, want_ll, gvec)
    same_in_grad = ctc.ctc_grad_reference(alphas, betas, out_lens, ll, gvec)
    live = want_alphas > 0.5 * ctc.NEG_INF
    live_b = want_betas > 0.5 * ctc.NEG_INF
    rows_abs = max(float((alphas - want_alphas)[live].abs().max()),
                   float((betas - want_betas)[live_b].abs().max()))
    rows_scale = max(float(want_alphas[live].abs().max()), float(want_betas[live_b].abs().max()))
    rows_apart = not (torch.equal(alphas > 0.5 * ctc.NEG_INF, live)
                      and torch.equal(betas > 0.5 * ctc.NEG_INF, live_b))
    loss_rel = float(((ll - want_ll).abs() / want_ll.abs()).max())
    grad_abs = float((grad - want_grad).abs().max())
    grad_same_abs = float((grad - same_in_grad).abs().max())
    del want_alphas, want_betas, same_in_grad, live, live_b
    what = f"ctc B={B} T={T} L={L}"
    check(not any(bool(t.isnan().any()) for t in (alphas_only, alphas, betas, grad)),
          f"{what}: NaN in an output")
    check(torch.equal(alphas_only, alphas), f"{what}: ctc_alpha and ctc_alpha_beta disagree")
    check(not rows_apart, f"{what}: the rows' states on the NEG_INF scale differ")
    check(rows_abs <= 1e-5 * rows_scale, f"{what}: alpha/beta rows max-abs {rows_abs} > 1e-5 "
          f"of {rows_scale}")
    check(loss_rel <= 1e-5, f"{what}: loss rel {loss_rel} > 1e-5")
    check(grad_abs <= 1e-5, f"{what}: grad max-abs {grad_abs} > 1e-5")

    targets = torch.arange(1, L + 1, device="cuda").expand(B, L)
    lp_tbc = lp.transpose(0, 1).contiguous()
    lp_g = lp_tbc.clone().requires_grad_(True)

    def lib_fwd():
        return F.ctc_loss(lp_tbc, targets, out_lens, in_lens, blank=0, reduction="none",
                          zero_infinity=True)

    def lib_fwd_bwd():
        loss = F.ctc_loss(lp_g, targets, out_lens, in_lens, blank=0, reduction="none",
                          zero_infinity=True)
        return torch.autograd.grad(loss, lp_g, gvec)

    feasible = out_lens.clamp(max=T) >= in_lens  # F.ctc_loss gives 0 (zero_infinity) elsewhere
    lib_rel = float(((lib_fwd() + ll).abs() / ll.abs())[feasible].max())
    fns = {"fwd": lambda: ctc.ctc_alpha(lp, out_lens),
           "fwd_grad": lambda: ctc.ctc_alpha_beta(lp, in_lens, out_lens),
           "bwd": lambda: ctc.ctc_grad(alphas, betas, out_lens, ll, gvec),
           "lib_fwd": lib_fwd, "lib_fwd_bwd": lib_fwd_bwd}
    # F.ctc_loss copies the lengths to the host inside: its device time is
    # the sum of its kernels in a profiler trace
    ms = {k: (time_ms(fn, iters=10), (kernels_ms if k.startswith("lib") else device_ms)(fn))
          for k, fn in fns.items()}
    plain = {"fwd": time_ms(lambda: ctc.ctc_alpha_reference(lp, out_lens), warmup=1, iters=2),
             "fwd_grad": time_ms(lambda: (ctc.ctc_alpha_reference(lp, out_lens),
                                          ctc.ctc_beta_reference(lp, in_lens, out_lens)),
                                 warmup=1, iters=2),
             "bwd": time_ms(lambda: ctc.ctc_grad_reference(alphas, betas, out_lens, ll, gvec),
                            warmup=1, iters=2)}
    # bytes these lengths need: the live frames' logprobs rows read once, every
    # row written once; the gradient reads the live frames' alpha and beta
    # rows. Operations: about ten a state and frame (exp and log as one each).
    frames = int(out_lens.clamp(max=T).sum())
    rows_bytes = B * T * S * 4
    bounds = {"fwd": bound_ms(10.0 * B * T * S, frames * (L + 1) * 4 + rows_bytes + B * 4,
                              "float32"),
              "fwd_grad": bound_ms(20.0 * B * T * S, frames * (L + 1) * 4 + 2 * rows_bytes
                                   + 2 * B * 4, "float32"),
              "bwd": bound_ms(3.0 * frames * S, 2 * frames * S * 4 + B * T * (L + 1) * 4
                              + 3 * B * 4, "float32")}
    errs = {"fwd": rows_abs, "fwd_grad": rows_abs, "bwd": grad_same_abs}
    row = dict(shape=[B, T, L], dtype="float32", loss_rel=loss_rel, grad_max_abs=grad_abs)
    for k in ("fwd", "fwd_grad", "bwd"):
        row[k] = dict(max_abs_err=errs[k], ms=ms[k][0], device_ms=ms[k][1], plain_ms=plain[k],
                      bound_ms=bounds[k][0], bound_by=bounds[k][1],
                      ns_per_frame=ms[k][1] * 1e6 / T)
    row["library"] = {k: dict(ms=ms[k][0], device_ms=ms[k][1]) for k in ("lib_fwd", "lib_fwd_bwd")}

    fb = ms["fwd_grad"][1] + ms["bwd"][1]
    log(f"{what}: loss rel={loss_rel:.3e} grad max_abs={grad_abs:.3e} (alpha/beta rows "
        f"max_abs {rows_abs:.3e}, gradient on the same rows {grad_same_abs:.3e}; F.ctc_loss "
        f"against ours: rel {lib_rel:.3e})")
    for k, name in (("fwd", "ctc_alpha (forward, no gradient)"),
                    ("fwd_grad", "ctc_alpha_beta (forward, both chains)"),
                    ("bwd", "ctc_grad (backward)")):
        r = row[k]
        what_bounds = ("a pass over bytes" if k == "bwd" else
                       f"what bounds the time is the chain of {T} frames, "
                       f"{r['ns_per_frame']:.1f} ns a frame")
        log(f"  {name}: kernel_ms={r['ms']:.4f} (device {r['device_ms']:.4f}) "
            f"plain_ms={r['plain_ms']:.2f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; "
            f"{what_bounds})")
    lib_dev = {k: "not measured" if ms[k][1] is None else f"{ms[k][1]:.4f}"
               for k in ("lib_fwd", "lib_fwd_bwd")}
    log(f"  forward+backward device {fb:.4f} ms; F.ctc_loss forward {ms['lib_fwd'][0]:.4f} "
        f"(device, its kernels in a profiler trace: {lib_dev['lib_fwd']}), forward+backward "
        f"{ms['lib_fwd_bwd'][0]:.4f} (device {lib_dev['lib_fwd_bwd']})")
    del lp, lp_tbc, lp_g, alphas, betas, grad, want_grad, alphas_only
    torch.cuda.empty_cache()
    return row


def phase_ctc() -> dict:
    """Kernel C at B = 16, T = 1024, L = 160 (lengths drawn from [L/4, L]
    and [T/2, T], item 0 full)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    B, T, L = 16, 1024, 160
    in_lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
    out_lens = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g)
    in_lens[0], out_lens[0] = L, T
    return ctc_case(B, T, L, in_lens, out_lens, SEED + 6)


def phase_ctc_buckets(workdir: Path, shapes: list) -> list:
    """Kernel C at each length bucket the trainer cut in phase 11, with the
    bucket's text and mel lengths: (B, T, L) as train_log.jsonl logged them
    (`shapes`, [B, L, T] a step). Returns the rows, the top bucket last."""
    rows = []
    for T, mel_lens, L, text_lens in _bucket_lengths(workdir):
        check([len(mel_lens), L, T] in shapes, f"bucket {len(mel_lens), L, T} was not trained")
        rows.append(ctc_case(len(mel_lens), T, L, text_lens, mel_lens, SEED + 10 + T))
    return rows


# -- phase 11: training through the CLI --------------------------------------

N_UTTS = 64  # training list
N_VAL = 64  # validation list: batches of 16 across the buckets


def write_corpus(root: Path, cfg: dict, rng, speakers=("default",),
                 languages=("default",)) -> None:
    """A seeded preprocessed corpus in the layout the dataset reads: per
    utterance a mel spec [n_mels, T], frame-level pitch and energy, a
    diagonal attention prior [T, L]; stats.json and the filelists (N_UTTS
    training utterances, N_VAL others for validation). Texts of 20-200
    characters, mels of 100-2000 frames (one of exactly 2000, so a bucket
    pads above 1536 frames). Utterance i is spoken by speaker i mod S in
    language (i div S) mod N; the texts and lengths depend on `rng` alone."""
    import numpy as np

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.text import TextProcessor

    config = FastSpeech2Config.from_dict(cfg)
    tp = TextProcessor(config.text)
    n_mels = config.preprocessing.audio.n_mels
    spec_name = f"spec-{config.preprocessing.audio.input_sampling_rate}-" \
                f"{config.preprocessing.audio.spec_type}.npy"
    for kind in ("spec", "pitch", "energy", "attn"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(N_UTTS + N_VAL):
        n_chars = int(rng.integers(20, 201))
        words = []
        while len(" ".join(words)) < n_chars:
            words.append(str(rng.choice(WORDS)))
        text = " ".join(words)[:n_chars].strip()
        L = len(tp.encode_text(text))
        T = 2000 if i == 0 else int(np.clip(L * rng.uniform(6, 10), 100, 2000))
        spk, lang = speakers[i % len(speakers)], languages[i // len(speakers) % len(languages)]
        name = f"utt{i:03d}--{spk}--{lang}--"
        mel = (rng.standard_normal((n_mels, T)) - 4.0).astype(np.float32)
        np.save(root / "spec" / (name + spec_name), mel)
        voiced = rng.random(T) > 0.2
        np.save(root / "pitch" / (name + "pitch.npy"),
                (rng.standard_normal(T) * voiced).astype(np.float32))
        np.save(root / "energy" / (name + "energy.npy"),
                rng.standard_normal(T).astype(np.float32))
        centre = np.arange(T)[:, None] / max(T - 1, 1) * (L - 1)
        prior = np.exp(-((np.arange(L)[None, :] - centre) ** 2) / (2 * (L / 8 + 1) ** 2))
        np.save(root / "attn" / (name + "characters-attn-prior.npy"),
                (prior / prior.sum(1, keepdims=True)).astype(np.float32))
        rows.append(f"utt{i:03d}|{spk}|{lang}|{text}")
    header = "basename|speaker|language|characters"
    (root / "training_filelist.psv").write_text("\n".join([header] + rows[:N_UTTS]) + "\n")
    (root / "validation_filelist.psv").write_text("\n".join([header] + rows[N_UTTS:]) + "\n")
    (root / "stats.json").write_text(json.dumps(STATS))


TRAIN_STEPS = 8
PHASE11_STEP8 = "phase11_step8"  # a copy of phase 11's step=8/, before later runs prune it
RESUME_STEPS = 12  # the preempted run and its resume go on to here
TIMED_STEPS = 12  # each timing run's steps
SAVE_EVERY = 3  # in the timing run with async saves among its steps
SAVES = 3  # validations, synchronous and async saves timed
LOSS_KEYS = ("total", "spec", "postnet", "pitch", "energy", "duration", "attn_ctc", "attn_bin")
TRAIN_COUNTERS = ("attention_fwd", "attention_bwd", "mas_width1", "ctc_alpha", "ctc_alpha_beta",
                  "ctc_grad")


def _counters() -> dict:
    from fastspeech2_lightning_tpu_torch.ops import attention, ctc, mas

    fns = (attention.attention_fwd, attention.attention_bwd, mas.mas_width1, ctc.ctc_alpha,
           ctc.ctc_alpha_beta, ctc.ctc_grad)
    return {fn.__name__: fn for fn in fns}


def _train_and_validation_launches(run) -> tuple:
    """Run `run()` with every training counter set to 0 before it; returns
    (launches outside validation, launches inside it): the counters are
    read just before and just after each Trainer.validate."""
    from fastspeech2_lightning_tpu_torch.training import loop

    fns = _counters()
    for fn in fns.values():
        fn.launches = 0
    in_val = dict.fromkeys(fns, 0)
    validate = loop.Trainer.validate

    def counted(self, step, epoch):
        before = {k: fn.launches for k, fn in fns.items()}
        try:
            return validate(self, step, epoch)
        finally:
            for k, fn in fns.items():
                in_val[k] += fn.launches - before[k]

    loop.Trainer.validate = counted
    try:
        run()
    finally:
        loop.Trainer.validate = validate
    return {k: fn.launches - in_val[k] for k, fn in fns.items()}, in_val


def _rows(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _last_step(train_log: Path) -> int:
    """The step of the last complete line of a train_log.jsonl another
    process is writing."""
    lines = train_log.read_text().split("\n")[:-1]  # the last piece may be half written
    return json.loads(lines[-1])["step"] if lines else 0


def phase_train(workdir: Path) -> dict:
    """Train the default config (full width and depth, bf16, batch 16) for
    8 steps through the port's CLI entry, validating every 4 steps with an
    async checkpoint after each (EMA on, top 1 kept); the launches of the
    training and validation paths apart. Then SIGTERM a CLI run on its way
    to step 12 in a subprocess, resume it to 12, synthesize from step=12
    with and without EMA, and time validation, saves, a resume's load and
    steps with `prefetch_batches` 2 and 0 (`_trainer_timings`)."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, load_datasets
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
    from fastspeech2_lightning_tpu_torch.text.lookups import lookuptables_from_config
    from fastspeech2_lightning_tpu_torch.training.checkpoint import (
        latest_checkpoint, load_train_state, read_meta,
    )

    cfg = model_config("bfloat16")
    corpus = workdir / "corpus"
    t0 = time.time()
    write_corpus(corpus, cfg, np.random.default_rng(SEED + 7))
    cfg["preprocessing"]["save_dir"] = "corpus"
    cfg["training"].update(batch_size=16, training_filelist="corpus/training_filelist.psv",
                           validation_filelist="corpus/validation_filelist.psv",
                           val_check_interval=4, save_top_k_ckpts=1, ema_decay=0.999,
                           async_checkpoint=True)
    cfg["training"]["logger"].update(save_dir="logs", name="smoke", version="train")
    config_path = workdir / "config.json"
    config_path.write_text(json.dumps(cfg))
    log(f"train: corpus of {N_UTTS} training and {N_VAL} validation utterances written in "
        f"{time.time() - t0:.1f} s")

    config = FastSpeech2Config.from_file(config_path)
    _, val_ds = load_datasets(config, *lookuptables_from_config(config))
    val_batches = len(BucketedLoader(val_ds, min(16, max(len(val_ds), 1)),
                                     n_buckets=config.training.bucket_count,
                                     max_mel_length=config.model.max_mel_length))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tl, vl = _train_and_validation_launches(
        lambda: cli.main(["train", str(config_path), "--max-steps", str(TRAIN_STEPS)]))
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    log_dir = workdir / "logs" / "smoke" / "train"
    ckpt_dir = log_dir / "checkpoints"
    rows = _rows(log_dir / "train_log.jsonl")
    check(len(rows) == TRAIN_STEPS, f"{len(rows)} steps logged, want {TRAIN_STEPS}")
    for r in rows:
        check(all(k in r and math.isfinite(r[k]) for k in LOSS_KEYS + ("grad_norm",)),
              f"step {r['step']}: {r}")
        log(f"train step {r['step']}: B x L x T = {' x '.join(map(str, r['shape']))}, "
            f"{r['ms']:.1f} ms (+{r['wait_ms']:.1f} waiting for the batch), total "
            f"{r['total']:.4f}, attn_ctc {r['attn_ctc']:.4f}, grad_norm {r['grad_norm']:.3f}")
    check(max(r["shape"][2] for r in rows) > 1536, "no bucket above 1536 frames was trained")
    val_rows = _rows(log_dir / "val_log.jsonl")
    check([v["step"] for v in val_rows] == [4, 8], f"validations at {val_rows}")
    for v in val_rows:
        check(v["batches"] == val_batches and all(math.isfinite(v[k]) for k in LOSS_KEYS),
              f"validation at step {v['step']}: {v} ({val_batches} batches predicted)")
        log(f"validation at step {v['step']}: {v['batches']} batches in {v['ms']:.1f} ms "
            f"({v['ms'] / v['batches']:.1f} ms a batch), total {v['total']:.4f}")
    # a train step's CTC loss needs a gradient: both chains in one forward
    # launch, the gradient pass in the backward; a validation batch runs the
    # deterministic forward: A at p 0 in every Conformer layer, MAS once, the
    # alpha chain alone once
    n_val = len(val_rows) * val_batches
    want_t = {"attention_fwd": 8 * TRAIN_STEPS, "attention_bwd": 8 * TRAIN_STEPS,
              "mas_width1": TRAIN_STEPS, "ctc_alpha": 0, "ctc_alpha_beta": TRAIN_STEPS,
              "ctc_grad": TRAIN_STEPS}
    want_v = {"attention_fwd": 8 * n_val, "attention_bwd": 0, "mas_width1": n_val,
              "ctc_alpha": n_val, "ctc_alpha_beta": 0, "ctc_grad": 0}
    check(tl == want_t, f"training launches {tl}, predicted {want_t}")
    check(vl == want_v, f"validation launches {vl}, predicted {want_v} ({n_val} batches)")
    newest = latest_checkpoint(ckpt_dir)
    check(newest is not None and newest.name == f"step={TRAIN_STEPS}", f"newest {newest}")
    check(not list(ckpt_dir.glob("*.tmp")), "a .tmp checkpoint was left")
    shutil.copytree(newest, workdir / PHASE11_STEP8)  # phase 29's one-process reference
    check(read_meta(newest)["global_step"] == TRAIN_STEPS, "meta.json global_step")
    kept = sorted(p.name for p in ckpt_dir.iterdir())
    log(f"train: {TRAIN_STEPS} steps in {wall:.1f} s (model build, loader, validations and "
        f"first-step set-up included); peak memory {peak_gib:.2f} GiB; checkpoints kept "
        f"{kept}; launches: training {tl}, validation {vl}")

    s = _preempt(config_path, log_dir)
    before = len(_rows(log_dir / "train_log.jsonl"))
    tl2, vl2 = _train_and_validation_launches(
        lambda: cli.main(["train", str(config_path), "--max-steps", str(RESUME_STEPS)]))
    resumed = _rows(log_dir / "train_log.jsonl")[before:]
    check([r["step"] for r in resumed] == list(range(s + 1, RESUME_STEPS + 1)),
          f"the resume logged {[r['step'] for r in resumed]}, want {s + 1}..{RESUME_STEPS}")
    newest = latest_checkpoint(ckpt_dir)
    check(newest.name == f"step={RESUME_STEPS}", f"newest after the resume {newest}")
    check(load_train_state(newest)["count"] == RESUME_STEPS, "count after the resume")
    log(f"resume: steps {s + 1}..{RESUME_STEPS} from step={s}; launches: training {tl2}, "
        f"validation {vl2}")

    mels = {}
    for ema in (False, True):
        syn = Synthesizer.from_checkpoint(newest, use_ema=ema)
        check(syn.device.type == "cuda", f"step={RESUME_STEPS} loaded on {syn.device}")
        mel = syn.synthesize(["the trained model speaks."]).mels[0]
        check(mel.ndim == 2 and mel.shape[1] == 80 and bool(np.isfinite(mel).all()),
              f"synthesis from step={RESUME_STEPS} (use_ema={ema}) gave {mel.shape}")
        mels[ema] = mel
    check(mels[True].shape != mels[False].shape or not np.array_equal(mels[True], mels[False]),
          "the EMA and the raw weights synthesized the same mel")
    log(f"synthesis from step={RESUME_STEPS}: {mels[False].shape[0]} frames, with EMA "
        f"{mels[True].shape[0]} frames")

    timing = _trainer_timings(cfg, workdir)
    return dict(launches=tl, validation_launches=vl,
                ms_per_step=statistics.median(r["ms"] for r in rows[2:]), peak_gib=peak_gib,
                totals=[r["total"] for r in rows],
                shapes=[r["shape"] for r in rows], step_ms=[r["ms"] for r in rows],
                timing=timing)


def _preempt(config_path: Path, log_dir: Path) -> int:
    """Run the train CLI to step 12 in a subprocess, SIGTERM it once
    train_log.jsonl shows step 10; it must exit 0 with a checkpoint at the
    last step it logged. Returns that step."""
    from fastspeech2_lightning_tpu_torch.training.checkpoint import (
        latest_checkpoint, load_train_state,
    )

    train_log = log_dir / "train_log.jsonl"
    out_path = config_path.parent / "preempt.out"
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", PORT, "train", str(config_path), "--max-steps",
             str(RESUME_STEPS)], cwd=HERE, stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 300
            while proc.poll() is None and time.time() < deadline:
                if _last_step(train_log) >= 10:
                    break
                time.sleep(0.02)
            check(proc.poll() is None, f"the run ended (rc {proc.returncode}) before step 10 "
                  f"was seen: {out_path.read_text()[-2000:]}")
            sent = time.time()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = out_path.read_text()
    check(rc == 0, f"the SIGTERMed run exited {rc}: {text[-2000:]}")
    s = _rows(train_log)[-1]["step"]
    ckpt = latest_checkpoint(log_dir / "checkpoints")
    check(ckpt is not None and ckpt.name == f"step={s}", f"SIGTERM at step {s} left {ckpt}")
    count = load_train_state(ckpt)["count"]
    check(count == s, f"train_state.pt count {count}, want {s}")
    check("received signal" in text, "the run did not report the signal")
    log(f"preemption: SIGTERM after step 10 was logged; the run finished step {s}, "
        f"checkpointed it and exited 0 {time.time() - sent:.1f} s after the signal")
    return s


def _median(xs) -> float:
    return statistics.median(xs) if xs else float("nan")


def _trainer_timings(cfg: dict, workdir: Path) -> dict:
    """Fresh runs of TIMED_STEPS through Trainer.fit (EMA on, as phase 11)
    with no save and no validation among the timed steps: prefetch_batches
    2, 0, 0, 2 in turns, then 2 with an async save every SAVE_EVERY steps
    (a save's writer thread beside the steps). A step's wall is its step
    plus its wait for the batch, over steps 3.. of each run. Then, on the
    last run's trainer: the validation (3 passes over the validation list),
    synchronous saves and async ones (the blocking part, and until
    written), each SAVES times in turns, and a resume's load."""
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.training.checkpoint import (
        AsyncCheckpointWriter, save_checkpoint, take_snapshot,
    )
    from fastspeech2_lightning_tpu_torch.training.loop import Trainer

    def run(name, **training):
        c = json.loads(json.dumps(cfg))
        c["training"].update({"ckpt_epochs": 0, "ckpt_steps": None, "async_checkpoint": False,
                              "val_check_interval": 10**6,  # validated at the end only
                              **training})
        c["training"]["logger"]["version"] = name
        path = workdir / f"config_{name}.json"
        path.write_text(json.dumps(c))
        trainer = Trainer(FastSpeech2Config.from_file(path))
        rows = trainer.fit(max_steps=TIMED_STEPS)
        torch.cuda.synchronize()
        walls = [r["ms"] + r["wait_ms"] for r in rows[2:]]
        log(f"timing run {name}: step wall {', '.join(f'{w:.1f}' for w in walls)} ms (median "
            f"{_median(walls):.1f}; wait median {_median([r['wait_ms'] for r in rows[2:]]):.1f})")
        return trainer, rows[2:]

    timed = {2: [], 0: []}
    for prefetch in (2, 0, 0, 2):
        trainer, rows = run(f"prefetch{prefetch}_{len(timed[prefetch])}",
                            prefetch_batches=prefetch)
        timed[prefetch].append(rows)
    del trainer
    trainer, saving = run("prefetch2_async_saves", prefetch_batches=2, async_checkpoint=True,
                          ckpt_steps=SAVE_EVERY)

    val = [trainer.validate(TIMED_STEPS, 0) for _ in range(SAVES)]
    val_ms = _median([json.loads(line)["ms"] for line in
                      (trainer.log_dir / "val_log.jsonl").read_text().splitlines()[-SAVES:]])
    shapes = [[*map(int, b["text"].shape), int(b["mel"].shape[1])] for b in trainer.val_loader]
    check(all(math.isfinite(v["total"]) for v in val), f"validation losses {val}")

    args = (trainer.config.to_dict(), trainer.stats_dict, trainer.lang2id, trainer.speaker2id,
            trainer.symbols)
    sync_ms, blocking_ms, written_ms = [], [], []
    for _ in range(SAVES):
        t0 = time.perf_counter()
        save_checkpoint(trainer.ckpt_dir, take_snapshot(trainer.model, trainer.optimizer,
                                                        trainer.ema, TIMED_STEPS, 1), *args)
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        writer = AsyncCheckpointWriter()
        t0 = time.perf_counter()
        writer.save(trainer.ckpt_dir, trainer.model, trainer.optimizer, trainer.ema,
                    TIMED_STEPS, 1, *args)
        blocking_ms.append((time.perf_counter() - t0) * 1e3)
        writer.wait()
        written_ms.append((time.perf_counter() - t0) * 1e3)
    again = Trainer(trainer.config)
    again.restore(trainer.ckpt_path)
    load_ms = again.load_ms
    del trainer, again
    torch.cuda.empty_cache()

    def step_walls(runs):
        return [r["ms"] + r["wait_ms"] for rows in runs for r in rows]

    timing = {
        "validation_utterances": N_VAL,
        "validation_batches": len(shapes),
        "validation_batch_shapes": shapes,
        "validation_ms": val_ms,
        "validation_ms_per_batch": val_ms / len(shapes),
        "sync_save_ms": _median(sync_ms),
        "sync_save_ms_all": sync_ms,
        "async_save_blocking_ms": _median(blocking_ms),
        "async_save_blocking_ms_all": blocking_ms,
        "async_save_written_ms": _median(written_ms),
        "resume_load_ms": load_ms,
        "step_ms_prefetch_2": _median(step_walls(timed[2])),
        "step_ms_prefetch_0": _median(step_walls(timed[0])),
        "step_ms_prefetch_2_runs": [_median(step_walls([r])) for r in timed[2]],
        "step_ms_prefetch_0_runs": [_median(step_walls([r])) for r in timed[0]],
        "wait_ms_prefetch_2": _median([r["wait_ms"] for rows in timed[2] for r in rows]),
        "wait_ms_prefetch_0": _median([r["wait_ms"] for rows in timed[0] for r in rows]),
        "step_ms_prefetch_2_async_saves": _median(step_walls([saving])),
    }
    log(f"trainer timings: validation of {N_VAL} utterances in {len(shapes)} batches (B x L x T "
        f"{shapes}) {val_ms:.1f} ms, {timing['validation_ms_per_batch']:.1f} ms a batch; saves "
        f"sync {', '.join(f'{x:.1f}' for x in sync_ms)} ms, async blocking "
        f"{', '.join(f'{x:.1f}' for x in blocking_ms)} ms (written after "
        f"{', '.join(f'{x:.1f}' for x in written_ms)}); resume load {load_ms:.1f} ms; median "
        f"step wall {timing['step_ms_prefetch_2']:.1f} ms with prefetch 2 (runs "
        f"{timing['step_ms_prefetch_2_runs']}), {timing['step_ms_prefetch_0']:.1f} with 0 (runs "
        f"{timing['step_ms_prefetch_0_runs']}), {timing['step_ms_prefetch_2_async_saves']:.1f} "
        f"with prefetch 2 and an async save every {SAVE_EVERY} steps")
    return timing


# -- phase 12: card against CPU, one train step and one eval step ------------


def phase_train_card_vs_cpu(workdir: Path, conditioned: bool = False) -> None:
    """One f32 train step (2+2 layers, full width, every dropout 0, no
    PostNet) from the same weights and batch on the card and on the CPU, then
    one eval step of the CPU's post-step weights on both. `conditioned`: the
    speaker, language and style-token config on phase 17's corpus."""
    import copy

    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.dataset import (
        PAD_MULT_MEL, PAD_MULT_TEXT, FastSpeechDataset, _round_up, collate,
    )
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.text import TextProcessor
    from fastspeech2_lightning_tpu_torch.text.lookups import load_filelist
    from fastspeech2_lightning_tpu_torch.training.state import (
        AdamWNoam, init_like_flax,
    )
    from fastspeech2_lightning_tpu_torch.training.step import (
        batch_to_device, eval_step, step_generator, train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = conditioned_config("float32") if conditioned else model_config("float32")
    for part in ("encoder", "decoder"):
        cfg["model"][part].update(layers=2, dropout=0.0)
    for kind in ("pitch", "energy", "duration"):
        cfg["model"]["variance_predictors"][kind]["dropout"] = 0.0
    cfg["model"]["use_postnet"] = False
    corpus = workdir / ("corpus_conditioned" if conditioned else "corpus")
    cfg["preprocessing"]["save_dir"] = str(corpus)
    config = FastSpeech2Config.from_dict(cfg)
    items = load_filelist(corpus / "training_filelist.psv")
    lookups = ((COND_LANG2ID, COND_SPEAKER2ID) if conditioned
               else ({"default": 0}, {"default": 0}))
    ds = FastSpeechDataset(items, config, *lookups)
    samples = sorted((ds[i] for i in range(8)), key=lambda s: s["mel"].shape[0])[:4]
    batch = collate(samples, _round_up(max(len(s["text"]) for s in samples), PAD_MULT_TEXT),
                    _round_up(max(s["mel"].shape[0] for s in samples), PAD_MULT_MEL))
    batch["sample_weight"] = np.array([1, 1, 1, 0], np.float32)

    model = FastSpeech2(config, n_symbols=len(TextProcessor(config.text).symbols),
                        n_speakers=len(lookups[1]), n_languages=len(lookups[0]))
    init_like_flax(model, SEED)
    with torch.no_grad():
        for kind in ("pitch", "energy"):
            st = STATS[kind]
            getattr(model.variance_adaptor, f"{kind}_bins").copy_(
                torch.linspace(st["norm_min"], st["norm_max"], 255))
    label = "conditioned " if conditioned else ""
    if conditioned:
        check(set(batch["speaker_id"]) == {0, 1} or set(batch["language_id"]) == {0, 1},
              f"the batch holds one speaker and one language: {batch['speaker_id']}")
    results = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        db = batch_to_device(batch, dev)
        durations = m.forward_train(db, step_generator(0, 0, dev))["duration_target"].cpu()
        m.load_state_dict(model.state_dict())
        opt = AdamWNoam(list(m.named_parameters()), config.training)
        losses = train_step(m, opt, config, db, 0, 50)
        results[dev] = (durations, {k: float(v) for k, v in losses.items()},
                        {k: v.detach().cpu() for k, v in m.state_dict().items()})
    (d_gpu, l_gpu, p_gpu), (d_cpu, l_cpu, p_cpu) = results["cuda"], results["cpu"]
    check(torch.equal(d_gpu, d_cpu), "MAS durations differ between card and CPU")
    worst_loss = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-8) for k in l_cpu)
    check(worst_loss <= 1e-4, f"card vs CPU losses differ: {l_gpu} vs {l_cpu}")
    worst_param = max(float((p_gpu[k].float() - p_cpu[k].float()).abs().max()) for k in p_cpu)
    check(worst_param <= 1e-5, f"card vs CPU parameters after a step differ by {worst_param}")
    log(f"card vs CPU {label}train step (f32, TF32 off, 2+2 layers, B=4, "
        f"T={batch['mel'].shape[1]}): durations equal, worst loss rel {worst_loss:.3e}, worst "
        f"parameter max-abs {worst_param:.3e}")

    evals = {}
    for dev in ("cuda", "cpu"):  # the eval step from the CPU's post-step weights
        m = copy.deepcopy(model)
        m.load_state_dict(p_cpu)
        losses, out = eval_step(m.to(dev), config, batch_to_device(batch, dev), 50)
        evals[dev] = (out["duration_target"].cpu(), {k: float(v) for k, v in losses.items()})
    (d_gpu, l_gpu), (d_cpu, l_cpu) = evals["cuda"], evals["cpu"]
    check(torch.equal(d_gpu, d_cpu), "eval step: MAS durations differ between card and CPU")
    worst_eval = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-8) for k in l_cpu)
    check(worst_eval <= 1e-4, f"card vs CPU eval losses differ: {l_gpu} vs {l_cpu}")
    log(f"card vs CPU {label}eval step (same weights and batch): durations equal, worst loss "
        f"rel {worst_eval:.3e}")


# -- phase 15: the synthesize CLI ---------------------------------------------

N_SYN = 8  # utterances of 20-120 characters, and as many of 300-600 that chunk
SYN_BATCH = 8
TF_BATCH = 16
SPEC = "22050-mel-librosa"
SYN_FORMATS = ("wav", "spec", "textgrid", "readalong-xml", "readalong-html")
SYN_COUNTERS = TRAIN_COUNTERS + ("mrf_conv",)
SYN_RUNS = ("hifigan", "griffin-lim", "teacher")


def synthesis_filelist(path: Path, rng) -> None:
    """A filelist of N_SYN short and N_SYN long utterances (words with some
    punctuation, so that the long ones chunk at the checkpoint's stats)."""
    texts = []
    for lo, hi in ((20, 121), (300, 601)):
        for n in rng.integers(lo, hi, N_SYN):
            words = []
            while len(" ".join(words)) < n:
                w = str(rng.choice(WORDS))
                if rng.random() < 0.12:
                    w += str(rng.choice([",", ".", "?", "!", ";"]))
                words.append(w)
            texts.append(" ".join(words)[: n - 1].strip() + ".")
    # no speaker or language: phase 5's checkpoint names none
    path.write_text("basename|characters\n" + "".join(
        f"syn{i:02d}|{t}\n" for i, t in enumerate(texts)))


def _timed(fn, sink: list):
    """fn, with the ms of every call (the card synchronized around it)
    appended to `sink`."""
    import torch

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


class _Recorder:
    """Stands for the CLI's writers: records what a batch hands them (chunk
    texts and flags, frames, durations, the mel width), then runs them and
    times them, all together and each apart (by format)."""

    def __init__(self, writers: dict, run: dict):
        self.writers, self.run = writers, run

    def on_predict_batch_end(self, outputs, batch):
        self.run["batches"].append(dict(
            texts=list(batch["raw_text"]), last=list(batch["is_last_input_chunk"]),
            lens=[int(n) for n in outputs["tgt_lens"]], width=int(outputs["output"].shape[1]),
            durations=outputs["duration_rounded"]))
        start = time.perf_counter()
        for fmt, w in self.writers.items():
            t0 = time.perf_counter()
            w.on_predict_batch_end(outputs, batch)
            self.run["by_writer"].setdefault(fmt.value, []).append(
                (time.perf_counter() - t0) * 1e3)
        self.run["writers"].append((time.perf_counter() - start) * 1e3)

    def finalize(self):
        for w in self.writers.values():
            if hasattr(w, "finalize"):
                w.finalize()


class SynthesisProbe:
    """Wraps the port's ``synthesize_items`` while the CLI runs: each run
    gets a record of its batches (``_Recorder``) and the ms of every
    forward, vocoder call and writers' turn. Keeps the inputs of the first
    ``attention_fwd`` call at an odd length and of the first ``mas_width1``
    call, to hold the kernels against their plain versions at this path's
    shapes afterwards."""

    def __init__(self):
        self.runs = []
        self.captured = {}

    def __enter__(self):
        from fastspeech2_lightning_tpu_torch.models import conformer, variance_adaptor
        from fastspeech2_lightning_tpu_torch.synthesis import synthesize

        self._saved = [(synthesize, "synthesize_items", synthesize.synthesize_items),
                       (conformer, "attention_fwd", conformer.attention_fwd),
                       (variance_adaptor, "mas_width1", variance_adaptor.mas_width1)]
        real_items, real_att, real_mas = (s[2] for s in self._saved)
        captured = self.captured

        def attention(q, k, v, bias, scale, *args, **kwargs):
            if q.shape[2] % 2 and "attention_fwd" not in captured:
                captured["attention_fwd"] = (q.clone(), k.clone(), v.clone(), bias.clone(),
                                             scale)
            return real_att(q, k, v, bias, scale, *args, **kwargs)

        def mas(log_attn, in_lens, out_lens):
            if "mas_width1" not in captured:
                captured["mas_width1"] = (log_attn.clone(), in_lens.clone(), out_lens.clone())
            return real_mas(log_attn, in_lens, out_lens)

        def items(items, model, config, lang2id, speaker2id, writers, **kwargs):
            run = dict(forward=[], vocoder=[], vocoded=[], writers=[], by_writer={},
                       batches=[])
            self.runs.append(run)
            model.forward = _timed(model.forward, run["forward"])
            model.forward_teacher_forced = _timed(model.forward_teacher_forced, run["forward"])
            for w in writers.values():
                if hasattr(w, "vocoder"):
                    timed = _timed(w.vocoder, run["vocoder"])

                    def vocoder(mel, timed=timed):
                        run["vocoded"].append(list(mel.shape[:2]))
                        return timed(mel)
                    w.vocoder = vocoder
            return real_items(items, model, config, lang2id, speaker2id,
                              {"recorder": _Recorder(writers, run)}, **kwargs)

        synthesize.synthesize_items = items
        conformer.attention_fwd = attention
        variance_adaptor.mas_width1 = mas
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def _utterances(run: dict) -> list:
    """(full text, [frames of each chunk]) of every utterance a run wrote."""
    out, text, lens = [], "", []
    for b in run["batches"]:
        for t, last, n in zip(b["texts"], b["last"], b["lens"]):
            text, lens = text + t, lens + [n]
            if last:
                out.append((text, lens))
                text, lens = "", []
    return out


def _expected_files(utterances: list, formats, step: int) -> dict:
    """{relative path: frames} under the JAX package's file names."""
    from fastspeech2_lightning_tpu_torch.utils import slugify, truncate_basename

    pattern = {"wav": "wav/{}--default--default--ckpt=%d--v_ckpt=0--pred.wav" % step,
               "spec": "synthesized_spec/{}--default--default--spec-pred-%s.npy" % SPEC,
               "textgrid": "textgrids/{}--default--default--%s.TextGrid" % SPEC,
               "readalong-xml": "readalongs/{}--default--default--%s.readalong" % SPEC,
               "readalong-html": "readalongs/{}--default--default--%s.html" % SPEC}
    return {pattern[f].format(truncate_basename(slugify(text))): sum(lens)
            for text, lens in utterances for f in formats}


def _run_cli(name: str, argv: list, probe: SynthesisProbe) -> dict:
    """One CLI run with every counter set to 0 just before it and read just
    after; returns the run's record with its wall and launches."""
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import mrf_conv

    counters = {**_counters(), "mrf_conv": mrf_conv}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    cli.main(["synthesize", *argv])
    torch.cuda.synchronize()
    wall = time.time() - t0
    run = probe.runs[-1]
    run.update(name=name, wall_s=wall, launches={k: fn.launches for k, fn in counters.items()})
    return run


def _check_run(run: dict, out: Path, formats, step: int, batch: int, hop: int,
               targets: dict = None) -> dict:
    """The files, their lengths and the launches of one run; returns its
    summary (the figures phase 15 prints)."""
    import numpy as np
    from scipy.io import wavfile

    name = run["name"]
    utts = _utterances(run)
    chunks = sum(len(lens) for _, lens in utts)
    n = len(run["batches"])
    check(n == len(run["forward"]) == -(-chunks // batch),
          f"{name}: {n} batches, {len(run['forward'])} forwards for {chunks} chunks")
    want = _expected_files(utts, formats, step)
    got = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    check(got == sorted(want), f"{name}: files {got[:4]}..., want {sorted(want)[:4]}...")
    samples = 0
    for path, frames in want.items():
        if path.endswith(".npy"):
            spec = np.load(out / path)
            check(spec.shape == (80, frames) and bool(np.isfinite(spec).all()),
                  f"{name}: {path} {spec.shape}, want (80, {frames})")
        elif path.endswith(".wav"):
            rate, pcm = wavfile.read(out / path)
            check(rate == 22050 and pcm.shape == (frames * hop,),
                  f"{name}: {path} {pcm.shape} at {rate}, want {frames} x {hop} samples")
            check(frames == 0 or int(pcm.max()) != int(pcm.min()), f"{name}: {path} constant")
            samples += pcm.size
    if targets is not None:  # teacher forcing: the target mel lengths exactly
        for text, lens in utts:
            check(lens == [targets[text]], f"{name}: '{text[:20]}' {lens} frames, target "
                                           f"{targets[text]}")
    want_launches = dict.fromkeys(SYN_COUNTERS, 0)
    want_launches["attention_fwd"] = 8 * n
    want_launches["mas_width1"] = n if targets is not None else 0
    check(run["launches"] == want_launches,
          f"{name}: launches {run['launches']}, predicted {want_launches} ({n} batches)")
    wall = run["wall_s"]
    voc = run["vocoder"]
    writers = [w - v for w, v in zip(run["writers"], voc)] if voc else run["writers"]
    frames = sum(sum(lens) for _, lens in utts)
    summary = dict(
        wall_s=wall, batches=n, utterances=len(utts), chunks=chunks,
        widths=[b["width"] for b in run["batches"]],
        forward_ms=statistics.median(run["forward"]),
        vocoder_ms=statistics.median(voc) if voc else None,
        writers_ms=statistics.median(writers), utterances_per_s=len(utts) / wall,
        audio_s_per_s=(samples if samples else frames * hop) / 22050 / wall,
        launches={k: v for k, v in run["launches"].items() if v},
        vocoded=run["vocoded"],
        # each format's writer apart; the wav writer's without its vocoder
        by_writer_ms={fmt: statistics.median([t - v for t, v in zip(ts, voc)]
                                             if fmt == "wav" else ts)
                      for fmt, ts in run["by_writer"].items()})
    log(f"synthesize {name}: {len(utts)} utterances ({chunks} chunks) in {n} batches of "
        f"<= {batch}, mel widths {summary['widths']}; wall {wall:.2f} s; ms a batch (median): "
        f"forward {summary['forward_ms']:.1f}, "
        + (f"vocoder {summary['vocoder_ms']:.1f} (on [B, frames] {run['vocoded']}), "
           if voc else "")
        + f"writers {summary['writers_ms']:.1f} ("
        + ", ".join(f"{k} {v:.1f}" for k, v in summary["by_writer_ms"].items())
        + f"); {summary['utterances_per_s']:.2f} utterances/s, "
        f"{summary['audio_s_per_s']:.2f} " + ("audio" if samples else "mel")
        + f" s/s; launches {summary['launches']}")
    return summary


def griffin_lim_split(shape: list) -> dict:
    """Griffin-Lim's ms at a [B, frames] the runs vocoded: the whole call on
    the card, and apart the host's draws of the initial phases."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.config import AudioConfig
    from fastspeech2_lightning_tpu_torch.synthesis.griffin_lim import GriffinLimVocoder

    B, T = shape
    voc = GriffinLimVocoder(AudioConfig())
    mel = torch.randn(B, T, 80, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED)) - 4.0
    whole = time_ms(lambda: voc.device_fn(mel), warmup=1, iters=3)
    t0 = time.perf_counter()
    draws = [np.random.default_rng(b).random((T, 513)) for b in range(B)]
    t1 = time.perf_counter()
    for d in draws:  # the phasors as the JAX package makes them, on the host
        np.exp(2j * np.pi * d)
    t2 = time.perf_counter()
    draw, host_exp = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    log(f"griffin-lim at [{B}, {T} frames]: {whole:.1f} ms a call, of which the host's "
        f"draws of the initial phases {draw:.1f} ms; the {voc.n_iter} iterations and the "
        f"rest {whole - draw:.1f} ms (the phasors by numpy on the host would add "
        f"{host_exp:.1f} ms)")
    return dict(shape=shape, ms=whole, host_draws_ms=draw, host_phasors_ms=host_exp)


def phase_synthesize(workdir: Path) -> dict:
    """The port's synthesize CLI at full width on the card, in-process:
    free-running with phase 5's bf16 checkpoint and HiFiGAN V1 (all five
    formats, batches of 8), the same with Griffin-Lim (wav), and teacher
    forced from phase 11's step=12 on its validation list (spec, TextGrid,
    batches of 16). Then attention_fwd and mas_width1 against their plain
    versions on inputs the runs gave them."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, attention_reference
    from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference

    # the CLI's own numerics: PyTorch's defaults, which phases 6 and 12 changed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    filelist = workdir / "synthesis_filelist.psv"
    synthesis_filelist(filelist, np.random.default_rng(SEED + 11))
    step12 = workdir / "logs" / "smoke" / "train" / "checkpoints" / f"step={RESUME_STEPS}"
    val_list = workdir / "corpus" / "validation_filelist.psv"
    targets = {}
    for line in val_list.read_text().splitlines()[1:]:
        base, _, _, text = line.split("|")
        spec = workdir / "corpus" / "spec" / f"{base}--default--default--spec-{SPEC}.npy"
        targets[text] = np.load(spec, mmap_mode="r").shape[1]
    out = {k: workdir / f"synthesis_{k}" for k in ("hifigan", "griffin-lim", "teacher")}
    common = ["-f", str(filelist), "-b", str(SYN_BATCH)]
    with SynthesisProbe() as probe:
        runs = [
            _run_cli("hifigan", [str(workdir / "model.ckpt"), *common, "-v",
                                 str(workdir / "hifigan_v1.npz"), "-O", *SYN_FORMATS,
                                 "-o", str(out["hifigan"])], probe),
            _run_cli("griffin-lim", [str(workdir / "model.ckpt"), *common, "-v",
                                     "griffin-lim", "-O", "wav", "-o",
                                     str(out["griffin-lim"])], probe),
            _run_cli("teacher", [str(step12), "-f", str(val_list), "-T",
                                 str(workdir / "corpus"), "-b", str(TF_BATCH), "-O", "spec",
                                 "textgrid", "-o", str(out["teacher"])], probe),
        ]
    summary = {
        "hifigan": _check_run(runs[0], out["hifigan"], SYN_FORMATS, 0, SYN_BATCH, 256),
        "griffin-lim": _check_run(runs[1], out["griffin-lim"], ("wav",), 0, SYN_BATCH, 256),
        "teacher": _check_run(runs[2], out["teacher"], ("spec", "textgrid"), RESUME_STEPS,
                              TF_BATCH, 256, targets=targets),
    }
    check(max(len(lens) for _, lens in _utterances(runs[0])) > 1, "no utterance chunked")

    q, k, v, bias, scale = probe.captured["attention_fwd"]
    got = attention_fwd(q, k, v, bias, scale)
    torch.cuda.synchronize()
    max_abs, rel = errors(got, attention_reference(q.float(), k.float(), v.float(), bias,
                                                   scale))
    check(rel <= 2e-2, f"attention_fwd at the synthesize shape {list(q.shape)}: rel-L2 {rel}")
    la, in_lens, out_lens = probe.captured["mas_width1"]
    hard, dur = mas_width1(la, in_lens, out_lens)
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    check(torch.equal(hard, want_hard) and torch.equal(dur, want_dur),
          f"mas_width1 at the teacher-forced shape {list(la.shape)}: differs from the plain "
          f"version")
    log(f"synthesize kernels at the path's shapes: attention_fwd {list(q.shape)} "
        f"{str(q.dtype).split('.')[-1]} rel-L2 {rel:.3e} (max-abs {max_abs:.3e}); mas_width1 "
        f"{list(la.shape)} bit-exact")
    summary["shapes"] = {"attention_fwd": list(q.shape), "mas_width1": list(la.shape)}
    summary["griffin-lim"]["split"] = griffin_lim_split(
        max(runs[1]["vocoded"], key=lambda s: s[0] * s[1]))
    return summary


# -- phase 16: synthesis, card against CPU ------------------------------------


def phase_synthesize_card_vs_cpu(workdir: Path) -> None:
    """A 2+2-layer f32 model (full width, seeded weights) through the CLI on
    the card and on the CPU: a free-running batch and a teacher-forced batch
    (phase 11's corpus), then one Griffin-Lim call on both devices."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.synthesis.griffin_lim import GriffinLimVocoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config("float32")
    for part in ("encoder", "decoder"):
        cfg["model"][part]["layers"] = 2
    ckpt = write_checkpoint(workdir / "small.ckpt",
                            random_state_dict(cfg, np.random.default_rng(SEED + 12)), cfg,
                            STATS, lang2id={"default": 0}, speaker2id={"default": 0})
    lines = (workdir / "synthesis_filelist.psv").read_text().splitlines()
    short = workdir / "cvc_filelist.psv"
    short.write_text("\n".join([lines[0]] + lines[1:4]) + "\n")
    val = workdir / "cvc_validation.psv"
    val.write_text("\n".join((workdir / "corpus" / "validation_filelist.psv")
                             .read_text().splitlines()[:5]) + "\n")
    runs = {}
    with SynthesisProbe() as probe, SharedBins() as bins:
        for dev in ("cpu", "cuda"):
            with bins.on(dev):
                for kind, argv in (("free", ["-f", str(short), "-O", "spec", "textgrid",
                                             "readalong-xml"]),
                                   ("teacher", ["-f", str(val), "-T", str(workdir / "corpus"),
                                                "-O", "spec", "textgrid"])):
                    out = workdir / f"cvc_{kind}_{dev}"
                    cli.main(["synthesize", str(ckpt), *argv, "-b", "4", "-o", str(out),
                              "--device", dev])
                    runs[kind, dev] = (probe.runs[-1], out)
    flips = bins.held()
    for kind in ("free", "teacher"):
        (gpu, out_gpu), (cpu, out_cpu) = runs[kind, "cuda"], runs[kind, "cpu"]
        check(len(gpu["batches"]) == len(cpu["batches"]) == 1, f"{kind}: not one batch")
        d_gpu, d_cpu = gpu["batches"][0]["durations"], cpu["batches"][0]["durations"]
        check(np.array_equal(d_gpu, d_cpu), f"{kind}: durations differ between card and CPU")
        files = sorted(str(p.relative_to(out_cpu)) for p in out_cpu.rglob("*") if p.is_file())
        check(files == sorted(str(p.relative_to(out_gpu)) for p in out_gpu.rglob("*")
                              if p.is_file()), f"{kind}: file names differ")
        worst = 0.0
        for f in files:
            if f.endswith(".npy"):
                a, b = np.load(out_gpu / f), np.load(out_cpu / f)
                check(a.shape == b.shape, f"{kind}: {f} {a.shape} vs {b.shape}")
                worst = max(worst, float(np.abs(a - b).max()))
            else:
                check((out_gpu / f).read_bytes() == (out_cpu / f).read_bytes(),
                      f"{kind}: {f} differs between card and CPU")
        check(worst <= 1e-4, f"{kind}: spec max-abs {worst} > 1e-4")
        log(f"card vs CPU synthesize {kind} (f32, TF32 off, 2+2 layers, B=4, mel width "
            f"{gpu['batches'][0]['width']}): durations equal, {len(files)} files, spec "
            f"max-abs {worst:.3e}, TextGrid/ReadAlong byte-equal; pitch and energy buckets "
            f"differing at an edge (both runs) {flips}")

    audio = FastSpeech2Config.from_dict(cfg).preprocessing.audio
    specs = sorted((runs["free", "cpu"][1] / "synthesized_spec").glob("*.npy"))[:2]
    T = min(np.load(p).shape[1] for p in specs)
    mel = np.stack([np.load(p)[:, :T].T for p in specs]).astype(np.float32)
    wavs = {dev: GriffinLimVocoder(audio, device=dev)(mel)[0] for dev in ("cuda", "cpu")}
    err = float(np.abs(wavs["cuda"] - wavs["cpu"]).max())
    check(err <= 1e-4, f"Griffin-Lim card vs CPU max-abs {err} > 1e-4")
    log(f"card vs CPU Griffin-Lim ([2, {T} frames], 48 iterations): float wav max-abs "
        f"{err:.3e}")


# -- phase 17: conditioned training through the CLI ---------------------------

COND_SPEAKERS = ("spk_a", "spk_b")
COND_LANGUAGES = ("eng", "fra")
COND_SPEAKER2ID = {s: i for i, s in enumerate(COND_SPEAKERS)}
COND_LANG2ID = {lang: i for i, lang in enumerate(COND_LANGUAGES)}


def conditioned_config(dtype: str) -> dict:
    """The default config with speakers, languages and global style tokens."""
    cfg = model_config(dtype)
    cfg["model"].update(multispeaker=True, multilingual=True,
                        use_global_style_token_module=True)
    return cfg


def phase_train_conditioned(workdir: Path, plain: dict) -> dict:
    """Train the conditioned config (full width and depth, bf16, batch 16) 8
    steps through the CLI on phase 11's corpus spoken by 2 speakers in 2
    languages (the same texts and lengths, so the same batch shapes in the
    same order), one validation at the end: each kernel's launches a step
    as in phase 11, the style encoder's BatchNorm statistics moved, the
    step ms beside phase 11's at the same shapes, and the peak memory."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.checkpoint import read_checkpoint

    cfg = conditioned_config("bfloat16")
    corpus = workdir / "corpus_conditioned"
    write_corpus(corpus, cfg, np.random.default_rng(SEED + 7), COND_SPEAKERS, COND_LANGUAGES)
    cfg["preprocessing"]["save_dir"] = corpus.name
    cfg["training"].update(batch_size=16, training_filelist=f"{corpus.name}/training_filelist.psv",
                           validation_filelist=f"{corpus.name}/validation_filelist.psv",
                           val_check_interval=TRAIN_STEPS, save_top_k_ckpts=1,
                           ema_decay=0.999, async_checkpoint=True)
    cfg["training"]["logger"].update(save_dir="logs", name="smoke", version="conditioned")
    config_path = workdir / "config_conditioned.json"
    config_path.write_text(json.dumps(cfg))

    torch.cuda.reset_peak_memory_stats()
    tl, vl = _train_and_validation_launches(
        lambda: cli.main(["train", str(config_path), "--max-steps", str(TRAIN_STEPS)]))
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log_dir = workdir / "logs" / "smoke" / "conditioned"
    rows = _rows(log_dir / "train_log.jsonl")
    check(len(rows) == TRAIN_STEPS, f"conditioned: {len(rows)} steps logged")
    for r in rows:
        check(all(k in r and math.isfinite(r[k]) for k in LOSS_KEYS + ("grad_norm",)),
              f"conditioned step {r['step']}: {r}")
    same_shapes = [r["shape"] for r in rows] == plain["shapes"]
    (val,) = _rows(log_dir / "val_log.jsonl")
    n_val = val["batches"]
    check(all(math.isfinite(val[k]) for k in LOSS_KEYS), f"conditioned validation {val}")
    want_t = {"attention_fwd": 8 * TRAIN_STEPS, "attention_bwd": 8 * TRAIN_STEPS,
              "mas_width1": TRAIN_STEPS, "ctc_alpha": 0, "ctc_alpha_beta": TRAIN_STEPS,
              "ctc_grad": TRAIN_STEPS}
    want_v = {"attention_fwd": 8 * n_val, "attention_bwd": 0, "mas_width1": n_val,
              "ctc_alpha": n_val, "ctc_alpha_beta": 0, "ctc_grad": 0}
    check(tl == want_t, f"conditioned training launches {tl}, predicted {want_t}")
    check(vl == want_v, f"conditioned validation launches {vl}, predicted {want_v}")

    step_dir = log_dir / "checkpoints" / f"step={TRAIN_STEPS}"
    sd = read_checkpoint(step_dir / "model.ckpt")[0]["state_dict"]
    moved = []
    for i in range(6):
        mean, var = (sd[f"gst.ref_enc.convs.{3 * i + 1}.running_{k}"].float()
                     for k in ("mean", "var"))
        moved.append(float(mean.abs().max()) > 0 and float((var - 1).abs().max()) > 0)
    check(all(moved), f"the style encoder's BatchNorm statistics did not all move: {moved}")
    check(sd["speaker_embedding.weight"].shape[0] == 2
          and sd["language_embedding.weight"].shape[0] == 2, "speaker/language tables")

    gst_ms = _style_encoder_ms(max(r["shape"][2] for r in rows))
    ab = _conditioning_ab(workdir)
    ms = statistics.median(r["ms"] for r in rows[2:])
    # the same corpus lengths and loader seed give phase 11's batch shapes in
    # its order, so step k of both runs did the same work but the conditioning
    ratio = (statistics.median(c / p for c, p in zip([r["ms"] for r in rows][2:],
                                                     plain["step_ms"][2:]))
             if same_shapes else ms / plain["ms_per_step"])
    log(f"conditioned train: {TRAIN_STEPS} steps, median {ms:.1f} ms a step against "
        f"{plain['ms_per_step']:.1f} without speakers, languages and GST ("
        f"{'the same shapes in the same order, per-step' if same_shapes else 'other shapes:'} "
        f"ratio median {ratio:.3f}); peak memory {peak_gib:.2f} "
        f"GiB (phase 11: {plain['peak_gib']:.2f}); validation {n_val} batches in "
        f"{val['ms']:.1f} ms; launches: training {tl}, validation {vl}; the style encoder's "
        f"6 BatchNorms moved; the style encoder alone at the top bucket {gst_ms}; steps "
        f"in turns: conditioned / plain median {ab['ratio_median']:.3f}")
    return dict(launches=tl, validation_launches=vl, ms_per_step=ms, peak_gib=peak_gib,
                style_encoder=gst_ms, in_turns=ab,
                step_ms=[r["ms"] for r in rows], ratio_to_plain=ratio, same_shapes=same_shapes,
                step_dir=step_dir)


def _conditioning_ab(workdir: Path, rounds: int = 4) -> dict:
    """Train steps of the plain and the conditioned config (full width, bf16,
    batch 16, fresh weights) in turns (plain first in even rounds, last in
    odd ones) on one batch of each bucket of phase 11's corpus and of its
    conditioned copy (the same shapes): wall ms of a step between CUDA
    events, the first round left out; medians per bucket."""
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, FastSpeechDataset
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.text import TextProcessor
    from fastspeech2_lightning_tpu_torch.text.lookups import load_filelist
    from fastspeech2_lightning_tpu_torch.training.state import AdamWNoam, init_like_flax
    from fastspeech2_lightning_tpu_torch.training.step import batch_to_device, train_step

    runs = {}
    for name, cfg, corpus, lookups in (
            ("plain", model_config("bfloat16"), "corpus", ({"default": 0}, {"default": 0})),
            ("conditioned", conditioned_config("bfloat16"), "corpus_conditioned",
             (COND_LANG2ID, COND_SPEAKER2ID))):
        cfg["preprocessing"]["save_dir"] = str(workdir / corpus)
        config = FastSpeech2Config.from_dict(cfg)
        ds = FastSpeechDataset(load_filelist(workdir / corpus / "training_filelist.psv"), config,
                               *lookups)
        batches = {}
        for b in BucketedLoader(ds, 16, n_buckets=config.training.bucket_count, seed=SEED,
                                max_mel_length=config.model.max_mel_length):
            batches.setdefault((*b["text"].shape, b["mel"].shape[1]), batch_to_device(b, "cuda"))
        model = FastSpeech2(config, n_symbols=len(TextProcessor(config.text).symbols),
                            n_speakers=len(lookups[1]), n_languages=len(lookups[0]))
        init_like_flax(model, SEED)
        with torch.no_grad():
            for kind in ("pitch", "energy"):
                st = STATS[kind]
                getattr(model.variance_adaptor, f"{kind}_bins").copy_(
                    torch.linspace(st["norm_min"], st["norm_max"], 255))
        model = model.cuda().train()
        runs[name] = (model, AdamWNoam(list(model.named_parameters()), config.training), config,
                      batches)
    shapes = sorted(runs["plain"][3])
    check(shapes == sorted(runs["conditioned"][3]), "the two corpora cut other buckets")
    times = {name: {s: [] for s in shapes} for name in runs}
    for r in range(rounds):
        order = ("plain", "conditioned") if r % 2 == 0 else ("conditioned", "plain")
        for s in shapes:
            for name in order:
                model, opt, config, batches = runs[name]
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                train_step(model, opt, config, batches[s], r, 50)
                end.record()
                torch.cuda.synchronize()
                if r > 0:
                    times[name][s].append(start.elapsed_time(end))
    rows = [{"shape": list(s), "plain_ms": statistics.median(times["plain"][s]),
             "conditioned_ms": statistics.median(times["conditioned"][s])} for s in shapes]
    for row in rows:
        row["ratio"] = row["conditioned_ms"] / row["plain_ms"]
        log(f"train step in turns, B x L x T = {' x '.join(map(str, row['shape']))}: plain "
            f"{row['plain_ms']:.1f} ms, with speakers, languages and GST "
            f"{row['conditioned_ms']:.1f} ms ({row['ratio']:.3f}x; medians of {rounds - 1})")
    del runs
    torch.cuda.empty_cache()
    return {"buckets": rows, "ratio_median": statistics.median(r["ratio"] for r in rows)}


def _style_encoder_ms(T: int) -> dict:
    """Wall ms (CUDA events around single calls) and device ms (its kernels
    in a profiler trace; device_ms cannot queue it: a call waits on the host)
    of a full-width style encoder (f32, batch statistics) on a [16, T, 80]
    mel: the forward alone and forward + backward."""
    import torch

    from fastspeech2_lightning_tpu_torch.models.gst import StyleEncoder

    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    gst = StyleEncoder(idim=80, gst_token_dim=256).cuda()
    mel = torch.randn(16, T, 80, device="cuda", generator=g)

    def forward():
        with torch.no_grad():
            return gst(mel, use_running_average=False)

    def forward_backward():
        gst(mel, use_running_average=False).sum().backward()

    return {"shape": [16, T, 80], "forward_wall_ms": time_ms(forward, iters=10),
            "forward_device_ms": kernels_ms(forward),
            "forward_backward_wall_ms": time_ms(forward_backward, iters=10),
            "forward_backward_device_ms": kernels_ms(forward_backward)}


# -- phase 18: serving the conditioned checkpoint -----------------------------


def style_wav(path: Path, seed: int, f0: float, seconds: float = 2.0) -> Path:
    """A seeded 22.05 kHz PCM16 wav: a vowel-like harmonic tone at `f0` with
    vibrato and noise."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    sr = 22050
    t = np.arange(int(sr * seconds)) / sr
    phase = 2 * np.pi * f0 * (t + 0.002 * np.sin(2 * np.pi * 5 * t) / 5)
    x = sum(np.sin(k * phase) / k for k in range(1, 12)) * (0.5 + 0.5 * np.sin(np.pi * t / seconds))
    x = 0.3 * x / np.abs(x).max() + 0.01 * rng.standard_normal(t.size)
    wavfile.write(path, sr, (x * 32767).astype(np.int16))
    return path


def _count_forwards(syn) -> list:
    """Wrap syn._forward; returns the list it appends one entry a call to."""
    calls = []
    forward = syn._forward

    def counted(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs)

    syn._forward = counted
    return calls


def phase_serve_conditioned(workdir: Path, step_dir: Path) -> dict:
    """Serve phase 17's step=8/ (bf16) with a seeded style-reference wav:
    a speaker x language grid of concurrent mel requests (kernel A's
    launches: 8 a forward), the Synthesizer without a reference (style token
    0) and with a second reference (a different style embedding); then the
    card against the CPU in f32 with a reference."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.checkpoint import read_checkpoint
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.dataset import (
        PAD_MULT_TEXT, FastSpeechDataset, _round_up, collate,
    )
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd
    from fastspeech2_lightning_tpu_torch.serving import serve
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
    from fastspeech2_lightning_tpu_torch.synthesis.prepare import style_reference_mel
    from fastspeech2_lightning_tpu_torch.text.lookups import load_filelist
    from fastspeech2_lightning_tpu_torch.training.step import batch_to_device

    refs = [style_wav(workdir / f"style_{i}.wav", SEED + 20 + i, f0)
            for i, f0 in enumerate((110.0, 240.0))]
    texts = request_texts(np.random.default_rng(SEED + 21))[:2]
    server = serve(step_dir, port=0, max_batch=BATCH, style_reference=refs[0], warmup=True)
    syn = server.synthesizer
    check(syn.device.type == "cuda" and syn.config.model.use_global_style_token_module,
          "the conditioned checkpoint did not load as a GST model on the card")
    forwards = _count_forwards(syn)
    grid = [(s, lang) for s in COND_SPEAKERS for lang in COND_LANGUAGES]
    attention_fwd.launches = 0
    server.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(len(grid)) as pool:
            futures = [pool.submit(_post, server.address, {"text": texts[0], "speaker": s,
                                                           "language": lang, "format": "mel"})
                       for s, lang in grid]
            responses = [f.result() for f in futures]
        torch.cuda.synchronize()
        launches = attention_fwd.launches
    finally:
        server.shutdown()
    mels = {}
    for (s, lang), (status, body, seconds) in zip(grid, responses):
        check(status == 200, f"conditioned request {s}/{lang} answered {status}")
        mel = np.load(io.BytesIO(body))  # an 8-step model predicts few frames
        check(mel.ndim == 2 and mel.shape[1] == 80 and bool(np.isfinite(mel).all()),
              f"conditioned request {s}/{lang}: mel {mel.shape}")
        mels[s, lang] = mel
        log(f"conditioned request speaker={s} language={lang}: {mel.shape[0]} frames in "
            f"{seconds:.3f} s")
    check(launches == 8 * len(forwards) and launches > 0,
          f"attention_fwd launched {launches} times over {len(forwards)} forwards")

    direct = Synthesizer.from_checkpoint(step_dir)
    with torch.no_grad():
        embs = [direct.model.gst(torch.as_tensor(direct._style_reference_mel(r),
                                                 device="cuda")[None]) for r in refs]
        token = direct.model.gst.condition_on_gst_tokens(1)
    style_diff = float((embs[0] - embs[1]).abs().max())
    token_diff = float((embs[0] - token).abs().max())
    check(style_diff > 1e-3 and token_diff > 1e-3,
          f"style embeddings: two references differ by {style_diff}, a reference and token 0 "
          f"by {token_diff}")
    outs = {name: direct.synthesize([texts[1]], speaker=COND_SPEAKERS[1],
                                    language=COND_LANGUAGES[1], **kw).mels[0]
            for name, kw in (("token_0", {}), ("reference_a", {"style_reference": refs[0]}),
                             ("reference_b", {"style_reference": refs[1]}))}
    for name, mel in outs.items():
        check(mel.ndim == 2 and mel.shape[1] == 80 and bool(np.isfinite(mel).all()),
              f"{name}: mel {mel.shape}")
    log(f"conditioned Synthesizer: frames with token 0 / reference a / reference b: "
        f"{[m.shape[0] for m in outs.values()]}; style embeddings of the two references "
        f"differ by max-abs {style_diff:.4f}, reference a and token 0 by {token_diff:.4f}")

    # card against CPU in f32 with the checkpoint's weights and reference a:
    # the free-running forward (its durations: an 8-step model predicts few
    # frames) and the teacher-forced one on 4 corpus utterances of both
    # speakers and languages (MAS durations, the mel at the targets' length)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt, _ = read_checkpoint(step_dir / "model.ckpt")
    cfg32 = dict(ckpt["hyper_parameters"]["config"])
    cfg32["model"] = dict(cfg32["model"], dtype="float32")
    cfg32["preprocessing"] = dict(cfg32["preprocessing"],
                                  save_dir=str(workdir / "corpus_conditioned"))
    config = FastSpeech2Config.from_dict(cfg32)
    ref = torch.as_tensor(style_reference_mel(refs[0], config.preprocessing.audio))
    items = load_filelist(workdir / "corpus_conditioned" / "validation_filelist.psv")[:4]
    ds = FastSpeechDataset(items, config, COND_LANG2ID, COND_SPEAKER2ID, teacher_forcing=True,
                           inference=True)
    samples = [ds[i] for i in range(len(items))]
    batch = collate(samples, _round_up(max(len(x["text"]) for x in samples), PAD_MULT_TEXT), None)
    check(len(set(batch["speaker_id"])) == 2 and len(set(batch["language_id"])) == 2,
          f"the batch misses a speaker or language: {batch['speaker_id']}, "
          f"{batch['language_id']}")
    res = {}
    with SharedBins() as bins, torch.no_grad():
        for dev in ("cpu", "cuda"):
            model = FastSpeech2(config,
                                n_symbols=ckpt["state_dict"]["text_input_layer.weight"].shape[0],
                                n_speakers=2, n_languages=2)
            model.load_state_dict(ckpt["state_dict"], strict=True)
            model = model.to(dev).eval()
            db = batch_to_device(batch, dev)
            db["mel_style_reference"] = ref[None].expand(len(items), -1, -1).to(dev)
            with bins.on(dev):
                free = model(db["text"], db["src_lens"], 1024, speaker_id=db["speaker_id"],
                             language_id=db["language_id"],
                             mel_style_reference=db["mel_style_reference"])
                tf = model.forward_teacher_forced(db)
            res[dev] = {"free": free["duration_rounded"].cpu(),
                        "durations": tf["duration_rounded"].cpu(),
                        "mel": tf["postnet_output"].cpu()}
    flips = bins.held()
    for key in ("free", "durations"):
        check(torch.equal(res["cuda"][key], res["cpu"][key]),
              f"conditioned card vs CPU: {key} durations differ")
    mel_err = float((res["cuda"]["mel"] - res["cpu"]["mel"]).abs().max())
    check(mel_err <= 1e-3, f"conditioned card vs CPU mel max-abs {mel_err} > 1e-3")
    log(f"conditioned card vs CPU (f32, TF32 off, reference a, 2 speakers x 2 languages): "
        f"free-running and MAS durations equal, teacher-forced mel [{len(items)}, "
        f"{batch['mel'].shape[1]}] max-abs {mel_err:.3e}; pitch and energy buckets differing "
        f"at an edge {flips}")
    return dict(attention_fwd=launches, forwards=len(forwards), style_diff=style_diff,
                card_vs_cpu_mel_max_abs=mel_err, card_vs_cpu_bucket_flips=flips)


# -- phase 19: low-latency streaming over HTTP --------------------------------

STREAM_WINDOW = 128


def _stream_post(address, payload: dict):
    """(status, seconds to the first audio bytes, seconds to the whole body,
    body) of a /synthesize request whose answer is read as it arrives."""
    import http.client

    conn = http.client.HTTPConnection(address[0], address[1], timeout=600)
    t0 = time.time()
    conn.request("POST", "/synthesize", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body, first = b"", None
    while True:
        piece = resp.read1(1 << 16)
        if not piece:
            break
        body += piece
        if first is None and len(body) > 44:
            first = time.time() - t0
    total = time.time() - t0
    conn.close()
    return resp.status, first, total, body


def long_text(rng, n_chars: int = 700) -> str:
    words = []
    while len(" ".join(words)) < n_chars:
        w = str(rng.choice(WORDS))
        if rng.random() < 0.1:
            w += str(rng.choice([",", "."]))
        words.append(w)
    return " ".join(words)[:n_chars].strip() + "."


def phase_streaming(workdir: Path) -> dict:
    """Phase 5's checkpoint and fused f32 HiFiGAN V1 behind serve(): a long
    text as a low-latency stream (windows of 128 frames, margin 15) and as
    the batched wav, in turns: time to the first audio and to the whole
    body; mrf_conv launches a window (54: three fused stages of 18); the
    stream against device_fn of each whole mel (TF32 off); the MRF stage at
    the three B = 1 window shapes against its plain version."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd
    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import mrf_conv
    from fastspeech2_lightning_tpu_torch.serving import serve
    from fastspeech2_lightning_tpu_torch.synthesis.streaming import windowed_vocode

    server = serve(workdir / "model.ckpt", vocoder_path=workdir / "hifigan_v1.npz", port=0,
                   max_batch=BATCH, vocoder_fused=True, warmup=True)
    syn = server.synthesizer
    voc = syn.vocoder
    margin = voc.receptive_margin_frames
    check(margin == 15, f"V1 receptive margin {margin}, want 15")
    windows, window_ms, synthesize_ms = [], [], []
    device_fn, synthesize = voc.device_fn, syn.synthesize

    def counted(mel):  # a window: the caller copies its samples to the host next
        t0 = time.perf_counter()
        windows.append(tuple(mel.shape))
        wav = device_fn(mel)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3)
        return wav

    def timed(*args, **kwargs):  # the acoustic forward of all chunks (mels on the host)
        t0 = time.perf_counter()
        try:
            return synthesize(*args, **kwargs)
        finally:
            synthesize_ms.append((time.perf_counter() - t0) * 1e3)

    voc.device_fn = counted
    syn.synthesize = timed
    forwards = _count_forwards(syn)
    text = long_text(np.random.default_rng(SEED + 30))
    chunks = syn._chunk_text(text, None)
    low = {"text": text, "low_latency": True, "window": STREAM_WINDOW}
    server.start()
    try:
        _stream_post(server.address, low)  # first call: library set-up
        for record in (windows, window_ms, synthesize_ms, forwards):
            record.clear()
        attention_fwd.launches = mrf_conv.launches = 0
        status, first, total, body = _stream_post(server.address, low)
        torch.cuda.synchronize()
        launches = {"mrf_conv": mrf_conv.launches, "attention_fwd": attention_fwd.launches}
        n_windows, n_forwards, shapes = len(windows), len(forwards), sorted(set(windows))
        split = {"synthesize_ms": synthesize_ms[0], "first_window_ms": window_ms[0],
                 "window_ms_median": statistics.median(window_ms)}
        check(status == 200 and body[:4] == b"RIFF", f"low-latency request answered {status}")
        timings = {"low_latency": [(first, total)], "batched": []}
        for k in range(3):  # in turns: batched, low latency, ...
            for name, payload in (("batched", {"text": text}), ("low_latency", low)):
                st, f, t, b = _stream_post(server.address, payload)
                check(st == 200, f"{name} request answered {st}")
                timings[name].append((f, t))
                if name == "batched" and k == 0:
                    batched_body = b
        _, stats = _get(server.address, "/stats")
    finally:
        server.shutdown()
        voc.device_fn, syn.synthesize = device_fn, synthesize
    check(stats.get("low_latency_requests") == 5, f"/stats low_latency_requests: {stats}")
    W = STREAM_WINDOW + 2 * margin
    check(all(s[1] <= W for s in shapes), f"a window of more than {W} frames: {shapes}")
    check(launches["mrf_conv"] == 3 * MRF_LAUNCHES * n_windows,
          f"mrf_conv launched {launches['mrf_conv']} times for {n_windows} windows")
    check(launches["attention_fwd"] == 8 * n_forwards,
          f"attention_fwd launched {launches['attention_fwd']} times in {n_forwards} forwards")
    pcm_low = np.frombuffer(body[44:], dtype="<i2")
    pcm_batched = np.frombuffer(batched_body[44:], dtype="<i2")
    med = {name: (statistics.median(f for f, _ in ts), statistics.median(t for _, t in ts))
           for name, ts in timings.items()}
    log(f"low-latency stream ({len(text)} characters, {len(chunks)} chunks, "
        f"{pcm_low.size / voc.sample_rate:.2f} s of audio, {n_windows} windows of <= {W} "
        f"frames, shapes {shapes}): first audio {med['low_latency'][0] * 1e3:.1f} ms, whole "
        f"body {med['low_latency'][1] * 1e3:.1f} ms; batched wav: first audio "
        f"{med['batched'][0] * 1e3:.1f} ms, whole body {med['batched'][1] * 1e3:.1f} ms "
        f"(medians of {len(timings['low_latency'])} and {len(timings['batched'])}, in turns); "
        f"mrf_conv {launches['mrf_conv'] / n_windows:.0f} launches a window, attention_fwd "
        f"{launches['attention_fwd']} in {n_forwards} forward(s); in the counted stream the "
        f"acoustic forward of all chunks took {split['synthesize_ms']:.1f} ms, the first "
        f"window {split['first_window_ms']:.1f} ms, a window {split['window_ms_median']:.2f} ms "
        f"(median, wall with the host)")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the stream's one forward over all chunks; the batched wav's batches of
    # 8 pad their text otherwise, and in bf16 a duration near a rounding
    # boundary can land a frame apart
    mels = syn.synthesize(chunks, vocode=False).mels
    frames = sum(m.shape[0] for m in mels)
    check(pcm_low.size == frames * voc.hop and pcm_low.size > 0,
          f"stream {pcm_low.size} samples for {frames} frames")
    log(f"stream {pcm_low.size} samples ({frames} frames); batched wav {pcm_batched.size} "
        f"samples ({(pcm_batched.size - pcm_low.size) // voc.hop:+d} frames)")
    worst = 0.0
    for mel in mels:
        streamed = np.concatenate(list(windowed_vocode(voc, mel, window=STREAM_WINDOW)))
        T = mel.shape[0]
        if T <= W:  # one call at a 32-frame bucket: the zero-padded mel vocoded whole
            mel = np.pad(mel, ((0, min(W, 32 * -(-T // 32)) - T), (0, 0)))
        whole = voc.device_fn(torch.as_tensor(mel, device="cuda")[None])[0].float().cpu().numpy()
        whole = whole[: T * voc.hop]
        check(streamed.shape == whole.shape, f"stream {streamed.shape} vs whole {whole.shape}")
        rel = float(np.linalg.norm(streamed - whole) / max(np.linalg.norm(whole), 1e-30))
        worst = max(worst, rel)
    check(worst <= 1e-4, f"the stream differs from the whole-mel vocoding: rel-L2 {worst}")
    log(f"stream against device_fn of each whole mel ({len(mels)} mels of "
        f"{[m.shape[0] for m in mels]} frames, f32, TF32 off): worst rel-L2 {worst:.3e}")
    rows = phase_mrf(batch=1, frames=W, dtypes=("float32",))
    return dict(launches=launches, windows=n_windows, window_shapes=[list(s) for s in shapes],
                first_audio_ms=med["low_latency"][0] * 1e3, body_ms=med["low_latency"][1] * 1e3,
                batched_first_audio_ms=med["batched"][0] * 1e3,
                batched_body_ms=med["batched"][1] * 1e3, stream_rel_l2=worst, stages=rows,
                first_request_split=split,
                text_chars=len(text), chunks=len(chunks))


# -- phase 20: phone-level and phonological-feature models --------------------

LEVELS = ("phones", "phonological_features")
ENGLISH = ["The quick brown fox jumps over the lazy dog, and then it runs far away.",
           "She sells sea shells by the sea shore; the shells she sells are surely seashells.",
           "How much wood would a woodchuck chuck if a woodchuck could chuck wood?"]


def phase_pfs_phones(workdir: Path) -> dict:
    """A phone-level and a phonological-feature model at full width and
    depth (bf16) with seeded weights through the Synthesizer on English
    text (g2p): kernel A's launches, 8 a forward; then the same weights in
    f32 on the card and on the CPU."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for k, level in enumerate(LEVELS):
        cfg = model_config("bfloat16")
        cfg["model"]["target_text_representation_level"] = level
        cfg = FastSpeech2Config.from_dict(cfg).to_dict()  # with the g2p_ipa symbols
        sd = random_state_dict(cfg, np.random.default_rng(SEED + 40 + k))
        ckpt = write_checkpoint(workdir / f"{level}.ckpt", sd, cfg, STATS)
        syn = Synthesizer.from_checkpoint(ckpt)
        forwards = _count_forwards(syn)
        attention_fwd.launches = 0
        t0 = time.time()
        res = syn.synthesize(ENGLISH)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        launches = attention_fwd.launches
        check(launches == 8 * len(forwards) and launches > 0,
              f"{level}: attention_fwd launched {launches} times in {len(forwards)} forwards")
        for mel in res.mels:
            check(mel.ndim == 2 and mel.shape[0] > 0 and bool(np.isfinite(mel).all()),
                  f"{level}: mel {mel.shape}")
        cfg32 = dict(cfg, model=dict(cfg["model"], dtype="float32"))
        ckpt32 = write_checkpoint(workdir / f"{level}_f32.ckpt", sd, cfg32, STATS)
        r = {}
        with SharedBins() as bins:
            for dev in ("cpu", "cuda"):
                syn32 = Synthesizer.from_checkpoint(ckpt32, device=dev)
                with bins.on(dev):
                    r[dev] = syn32.synthesize(ENGLISH[:2])
        flips = bins.held()
        for a, b in zip(r["cuda"].durations, r["cpu"].durations):
            check(np.array_equal(a, b), f"{level}: card and CPU durations differ")
        mel_err = max(float(np.abs(a - b).max()) for a, b in zip(r["cuda"].mels, r["cpu"].mels))
        check(mel_err <= 1e-3, f"{level}: card vs CPU mel max-abs {mel_err} > 1e-3")
        n_ids = [int(d.shape[0]) for d in res.durations]
        log(f"{level} model (full width, bf16): {len(ENGLISH)} English sentences -> {n_ids} "
            f"phones, {[m.shape[0] for m in res.mels]} frames in {ms:.1f} ms; attention_fwd "
            f"{launches} in {len(forwards)} forward(s); card vs CPU (f32, TF32 off): durations "
            f"equal, mel max-abs {mel_err:.3e}, pitch and energy buckets differing at an edge "
            f"{flips}")
        out[level] = dict(attention_fwd=launches, forwards=len(forwards), ms=ms,
                          card_vs_cpu_mel_max_abs=mel_err, card_vs_cpu_bucket_flips=flips)
    return out


# -- main --------------------------------------------------------------------


# -- phases 21-23: vocoder training ---------------------------------------------

N_VOC = 32  # utterances of 1-4 s: the first N_VOC_VAL validate, the rest train
N_VOC_VAL = 8
VOC_STEPS = 40  # the CLI run: a checkpoint every VOC_CKPT steps, a log every VOC_LOG
VOC_CKPT = 20
VOC_LOG = 10
VOC_RESUME = 50  # the SIGTERMed run and its resume go on to here
VOC_TIMED = 4  # steps timed a precision a round
VOC_ROUNDS = 2
VOC_LOSSES = ("d", "g", "g_adv", "fm", "mel_l1")
VOC_MRF_STAGES = 3  # of V1's four stages C = 128, 64, 32 take the MRF kernel


def vocoder_wav(rng, seconds: float, sr: int = 22050):
    """A harmonic tone (8 partials at 1/h) on a 90-260 Hz pitch with 4-7 Hz
    vibrato, a 2-5 Hz syllable-like envelope and noise at about -30 dB,
    peaking at 0.5."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(90, 260) * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase) / h for h in range(1, 9))
    x = x * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6.3)))
    x = x + 0.03 * np.std(x) * rng.standard_normal(t.size)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def write_vocoder_corpus(root: Path, cfg: dict, rng) -> None:
    """N_VOC seeded utterances as preprocessing writes them: ``audio-22050.wav``
    (PCM16) and the log-mel ``spec`` of the wav as read back, under
    ``Preprocessor.artifact_path`` names, and the two filelists."""
    import numpy as np

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.preprocessing.features import mel_spectrogram_numpy
    from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import (
        Preprocessor, load_wav, save_wav,
    )

    config = FastSpeech2Config.from_dict(cfg)
    config.preprocessing.save_dir = str(root)
    a = config.preprocessing.audio
    pre = Preprocessor(config)
    rows = []
    for i in range(N_VOC):
        name = f"voc{i:03d}"
        wav_p = pre.artifact_path("audio", name, "default", "default",
                                  f"audio-{a.input_sampling_rate}.wav")
        save_wav(wav_p, vocoder_wav(rng, float(rng.uniform(1.0, 4.0))), a.input_sampling_rate)
        mel = mel_spectrogram_numpy(load_wav(wav_p, a.input_sampling_rate),
                                    a.input_sampling_rate, a.n_fft, a.fft_hop_size,
                                    a.fft_window_size, a.n_mels, a.f_min, a.f_max, a.spec_type)
        spec_p = pre.artifact_path("spec", name, "default", "default", pre.spec_filename())
        spec_p.parent.mkdir(parents=True, exist_ok=True)
        np.save(spec_p, mel)
        rows.append(f"{name}|default|default|utterance {i}")
    header = "basename|speaker|language|characters"
    (root / "training_filelist.psv").write_text("\n".join([header] + rows[N_VOC_VAL:]) + "\n")
    (root / "validation_filelist.psv").write_text("\n".join([header] + rows[:N_VOC_VAL]) + "\n")


def _voc_counters() -> dict:
    from fastspeech2_lightning_tpu_torch.ops import attention, ctc, mas, vocoder_resblocks

    return {"attention_fwd": attention.attention_fwd, "attention_bwd": attention.attention_bwd,
            "mas_width1": mas.mas_width1, "ctc_alpha": ctc.ctc_alpha,
            "ctc_alpha_beta": ctc.ctc_alpha_beta, "ctc_grad": ctc.ctc_grad,
            "mrf_conv": vocoder_resblocks.mrf_conv}


def _voc_preempt(config_path: Path, log_path: Path, after: int) -> int:
    """The train-vocoder CLI to VOC_RESUME in a subprocess, SIGTERMed once
    its log shows step `after`: it must exit 0 with a checkpoint at the last
    step it logged. Returns that step."""
    out_path = config_path.parent / "vocoder_preempt.out"
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", PORT, "train-vocoder", str(config_path), "--max-steps",
             str(VOC_RESUME), "--ckpt-steps", str(VOC_CKPT), "--log-steps", "1"],
            cwd=HERE, stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 300
            while proc.poll() is None and time.time() < deadline:
                if _last_step(log_path) >= after:
                    break
                time.sleep(0.02)
            check(proc.poll() is None, f"the vocoder run ended (rc {proc.returncode}) before "
                  f"step {after}: {out_path.read_text()[-2000:]}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = out_path.read_text()
    check(rc == 0 and "received signal" in text, f"the SIGTERMed vocoder run exited {rc}: "
                                                  f"{text[-2000:]}")
    return _rows(log_path)[-1]["step"]


def vocoder_step_flops(step, state, batch) -> int:
    """Floating-point operations of one step, counted by
    torch.utils.flop_counter from the shapes of its convolutions and
    products, forward and backward (the generator once, D at 2B for its
    update, D on the fake with input gradients and on the real without for
    G's; the weight norm, the mel and the optimizer's element-wise work are
    not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    return counter.get_total_flops()


def _vocoder_timings(config, ckpt_dir: Path) -> dict:
    """Steps of the full-width D+G at B = 16 and 32-frame crops, bf16 and f32
    in turns (wall and device ms), the bf16 step's peak memory and FLOPs, a
    save's wall and a resume's load, and the parameter counts."""
    import torch

    from fastspeech2_lightning_tpu_torch.models.hifigan import HiFiGANConfig
    from fastspeech2_lightning_tpu_torch.models.hifigan_discriminators import (
        DiscriminatorConfig, count_params,
    )
    from fastspeech2_lightning_tpu_torch.training import vocoder as tv

    a = config.preprocessing.audio
    gen_cfg = HiFiGANConfig(n_mels=a.n_mels, sampling_rate=a.output_sampling_rate,
                            hop_size=a.fft_hop_size)
    disc_cfg = DiscriminatorConfig()
    loader = tv.VocoderCropLoader(config, tv.VocoderTrainingConfig())
    batches = [{k: torch.from_numpy(v).cuda() for k, v in loader.next_batch().items()}
               for _ in range(2)]
    runs = {}
    for dtype in ("bfloat16", "float32"):
        tc = tv.VocoderTrainingConfig(compute_dtype=dtype)
        state = tv.create_vocoder_state(gen_cfg, disc_cfg, tc, device="cuda")
        runs[dtype] = (state, tv.make_vocoder_train_step(gen_cfg, disc_cfg, tc, a))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, step = runs["bfloat16"]
    step(state, batches[0])
    torch.cuda.synchronize()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    walls = {d: [] for d in runs}
    i = 0
    for r in range(VOC_ROUNDS):
        for dtype in (("bfloat16", "float32") if r % 2 == 0 else ("float32", "bfloat16")):
            state, step = runs[dtype]

            def one(state=state, step=step):
                nonlocal i
                i += 1
                step(state, batches[i % 2])

            walls[dtype].append(time_ms(one, warmup=1, iters=VOC_TIMED))
    # a step launches more kernels than a stream queues, so device_ms cannot
    # queue it behind a spin: the device time comes from a profiler trace
    device = {}
    for dtype, (state, step) in runs.items():
        device[dtype] = device_busy_ms(lambda state=state, step=step: step(state, batches[0]))
    flops = vocoder_step_flops(runs["bfloat16"][1], runs["bfloat16"][0], batches[0])
    # the JAX step runs the generator forward once more (for the D update)
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        runs["bfloat16"][0].gen(batches[0]["mel"], torch.bfloat16)
    gen_forward_flops = counter.get_total_flops()
    gen_n, disc_n = count_params(runs["bfloat16"][0].gen), count_params(runs["bfloat16"][0].disc)
    # the parameters, their gradients and both Adam moments read and written once a step
    nbytes = (gen_n + disc_n) * 4 * 8
    bound, bound_by = bound_ms(flops, nbytes, "bfloat16")

    state = runs["bfloat16"][0]
    torch.cuda.synchronize()
    t0 = time.time()
    saved = tv.save_vocoder_checkpoint(ckpt_dir, state)
    save_ms = (time.time() - t0) * 1e3
    fresh = runs["float32"][0]  # the bf16 run's checkpoint loaded over the f32 run's state
    torch.cuda.synchronize()
    t0 = time.time()
    tv.load_vocoder_training_checkpoint(saved, fresh)
    torch.cuda.synchronize()
    load_ms = (time.time() - t0) * 1e3
    check(fresh.step == state.step and all(
        torch.equal(p, q) for p, q in zip(fresh.gen.parameters(), state.gen.parameters())),
        "the resumed vocoder state differs from the saved one")
    return dict(ms_per_step={d: statistics.median(w) for d, w in walls.items()},
                ms_rounds=walls, device=device, peak_gib=peak_gib, flops=flops,
                gen_forward_flops=gen_forward_flops,
                bound_ms=bound, bound_by=bound_by, save_ms=save_ms, load_ms=load_ms,
                params={"generator": gen_n, "discriminators": disc_n},
                shape={"batch": 16, "frames": 32, "samples": 32 * a.fft_hop_size})


def phase_vocoder_train(workdir: Path) -> dict:
    """Phase 21: the full-width HiFiGAN V1 against the default MPD + MSD through
    the ``train-vocoder`` CLI (B 16, 32-frame crops, bf16) on a seeded corpus,
    VOC_STEPS steps with a checkpoint every VOC_CKPT; finite losses and a
    falling mel L1; no kernel launched. Then a SIGTERMed CLI run, its resume
    to VOC_RESUME, and the timings of ``_vocoder_timings``."""
    import numpy as np

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.training.checkpoint import latest_checkpoint

    cfg = json.loads(json.dumps(model_config("bfloat16")))
    t0 = time.time()
    write_vocoder_corpus(workdir / "vcorpus", cfg, np.random.default_rng(SEED + 21))
    cfg["preprocessing"]["save_dir"] = "vcorpus"
    cfg["training"].update(training_filelist="vcorpus/training_filelist.psv",
                           validation_filelist="vcorpus/validation_filelist.psv")
    cfg["training"]["logger"].update(save_dir="vlogs")
    config_path = workdir / "vocoder_config.json"
    config_path.write_text(json.dumps(cfg))
    log(f"vocoder train: corpus of {N_VOC} utterances of 1-4 s written in "
        f"{time.time() - t0:.1f} s")
    log_dir = workdir / "vlogs" / "vocoder"
    ckpt_dir = log_dir / "checkpoints"
    log_path = log_dir / "vocoder_log.jsonl"

    counters = _voc_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    cli.main(["train-vocoder", str(config_path), "--max-steps", str(VOC_STEPS),
              "--ckpt-steps", str(VOC_CKPT), "--log-steps", str(VOC_LOG)])
    wall = time.time() - t0
    launched = {name: fn.launches for name, fn in counters.items()}
    check(not any(launched.values()), f"vocoder training launched kernels: {launched}")
    rows = _rows(log_path)
    want = [1] + list(range(VOC_LOG, VOC_STEPS + 1, VOC_LOG))
    check([r["step"] for r in rows] == want, f"logged steps {[r['step'] for r in rows]}")
    for r in rows:
        check(all(math.isfinite(r[k]) for k in VOC_LOSSES), f"vocoder step {r['step']}: {r}")
        log(f"vocoder step {r['step']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in VOC_LOSSES))
    check(rows[-1]["mel_l1"] < rows[0]["mel_l1"],
          f"mel_l1 did not fall: {rows[0]['mel_l1']} -> {rows[-1]['mel_l1']}")
    dirs = sorted((p.name for p in ckpt_dir.glob("step=*")), key=lambda n: int(n[5:]))
    check(dirs == [f"step={s}" for s in range(VOC_CKPT, VOC_STEPS + 1, VOC_CKPT)],
          f"checkpoints {dirs}")
    check((ckpt_dir / "vocoder.npz").is_file(), "no vocoder.npz")
    log(f"vocoder train: {VOC_STEPS} steps in {wall:.1f} s (state build, loader and "
        f"checkpoints included); checkpoints {dirs}")

    after = (VOC_STEPS + VOC_RESUME) // 2
    s = _voc_preempt(config_path, log_path, after)
    newest = latest_checkpoint(ckpt_dir)
    meta = json.loads((newest / "meta.json").read_text())
    check(newest.name == f"step={s}" and meta["global_step"] == s,
          f"SIGTERM after step {s} left {newest.name}")
    import torch

    saved = torch.load(newest / "train_state.pt", map_location="cpu", weights_only=True)
    counts = {int(v["step"]) for part in ("opt_g", "opt_d")
              for v in saved[part]["state"].values()}
    check(counts == {s}, f"the optimizers' step counts {counts}, want {s}")
    before = len(_rows(log_path))
    cli.main(["train-vocoder", str(config_path), "--max-steps", str(VOC_RESUME),
              "--ckpt-steps", str(VOC_CKPT), "--log-steps", "1"])
    resumed = [r["step"] for r in _rows(log_path)[before:]]
    check(resumed == list(range(s + 1, VOC_RESUME + 1)),
          f"the resume logged {resumed}, want {s + 1}..{VOC_RESUME}")
    check(latest_checkpoint(ckpt_dir).name == f"step={VOC_RESUME}",
          "no checkpoint at the resume's end")
    log(f"vocoder preemption: SIGTERM after step {after} was logged; the run "
        f"checkpointed step {s} and exited 0; the resume ran {s + 1}..{VOC_RESUME}")

    timing = _vocoder_timings(FastSpeech2Config.from_file(config_path), workdir / "vtiming")
    ms = timing["ms_per_step"]
    log(f"vocoder step (B 16, 8192 samples): wall bf16 {ms['bfloat16']:.1f} ms, f32 "
        f"{ms['float32']:.1f} ms (medians of rounds {timing['ms_rounds']}); profiled device "
        f"time bf16 {timing['device']['bfloat16']}, f32 {timing['device']['float32']}; "
        f"{timing['flops'] / 1e12:.3f} TFLOP a step (the JAX step's recipe, with a second "
        f"generator forward: {(timing['flops'] + timing['gen_forward_flops']) / 1e12:.3f}), "
        f"bound {timing['bound_ms']:.3f} ms "
        f"({timing['bound_by']}); peak {timing['peak_gib']:.2f} GiB; save "
        f"{timing['save_ms']:.1f} ms, resume's load {timing['load_ms']:.1f} ms; parameters "
        f"{timing['params']}")
    return dict(config_path=config_path, ckpt_dir=ckpt_dir, losses=rows, wall_s=wall,
                preempted_at=s, timing=timing)


def _vocoder_step_on(dev: str, gen_cfg, tc, audio, batch, ckpt: Path):
    """One f32 D+G step on `dev` from `ckpt`: (losses, gradients by
    parameter name on the host)."""
    import torch

    from fastspeech2_lightning_tpu_torch.models.hifigan_discriminators import (
        DiscriminatorConfig,
    )
    from fastspeech2_lightning_tpu_torch.training import vocoder as tv

    state = tv.create_vocoder_state(gen_cfg, DiscriminatorConfig(), tc, device=dev)
    tv.load_vocoder_training_checkpoint(ckpt, state)
    step = tv.make_vocoder_train_step(gen_cfg, DiscriminatorConfig(), tc, audio)
    losses = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    grads = {f"{side}.{k}": p.grad.double().cpu()
             for side, mod in (("gen", state.gen), ("disc", state.disc))
             for k, p in mod.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads


def phase_vocoder_card_vs_cpu(ckpt_dir: Path, config_path: Path) -> dict:
    """Phase 22: one f32 D+G step, TF32 off, on B = 2 full crops on the card
    and on the CPU from phase 21's last checkpoint: losses within 1e-4
    relative, each side's gradient (G's, D's, all parameters as one vector)
    within rel-L2 1e-3. Parameter by parameter the f32 gradients of some
    resblock convs lie up to about 1e-3 apart, as far as each device's f32
    lies from a float64 step (the mel L1's gradient is ill-conditioned
    there), while float64 steps on the card and the CPU agree
    (``tools/vocoder_grad_precision.py``); and near the LSGAN equilibrium
    the gradient of D's last biases is a difference of near-equal sums. The
    largest per-parameter errors are printed, not checked."""
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.models.hifigan import HiFiGANConfig
    from fastspeech2_lightning_tpu_torch.training import vocoder as tv
    from fastspeech2_lightning_tpu_torch.training.checkpoint import latest_checkpoint

    config = FastSpeech2Config.from_file(config_path)
    a = config.preprocessing.audio
    gen_cfg = HiFiGANConfig(n_mels=a.n_mels, sampling_rate=a.output_sampling_rate,
                            hop_size=a.fft_hop_size)
    tc = tv.VocoderTrainingConfig(batch_size=2, compute_dtype="float32", seed=SEED + 22)
    batch = tv.VocoderCropLoader(config, tc).next_batch()
    newest = latest_checkpoint(ckpt_dir)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (lc, gc), (lp, gp) = (_vocoder_step_on(dev, gen_cfg, tc, a, batch, newest)
                              for dev in ("cuda", "cpu"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    rel = {k: abs(lc[k] - lp[k]) / abs(lp[k]) for k in VOC_LOSSES}
    check(max(rel.values()) <= 1e-4, f"vocoder step losses card vs CPU: {rel}")
    grad_rel = {k: float(torch.linalg.vector_norm(gc[k] - gp[k])
                         / torch.linalg.vector_norm(gp[k]).clamp_min(1e-30)) for k in gp}
    worst = sorted(grad_rel, key=grad_rel.get)[::-1]
    side_rel = {}
    for side in ("gen", "disc"):
        keys = [k for k in gp if k.startswith(side + ".")]
        diff = torch.cat([(gc[k] - gp[k]).ravel() for k in keys])
        side_rel[side] = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(
            torch.cat([gp[k].ravel() for k in keys])))
    check(max(side_rel.values()) <= 1e-3, f"vocoder gradients card vs CPU: rel-L2 {side_rel}")
    log(f"vocoder card vs CPU (f32, TF32 off, {newest.name}, B 2 x 8192): losses rel max "
        f"{max(rel.values()):.2e}; gradients rel-L2 by side {side_rel}; by parameter "
        + ", ".join(f"{k} {grad_rel[k]:.2e}" for k in worst[:3]) + f" of {len(gp)}")
    return dict(state=newest.name, loss_rel=max(rel.values()), side_rel=side_rel,
                worst=[(k, grad_rel[k]) for k in worst[:3]])


def phase_trained_vocoder(workdir: Path, ckpt_dir: Path, config_path: Path) -> dict:
    """Phase 23: ``evaluate-vocoder`` on phase 21's vocoder.npz; the
    validation mels vocoded fused and unfused in f32 (TF32 off) within the
    MRF row's limit, with the ``mrf_conv`` launches counted around the fused
    run; one request through the Synthesizer with that vocoder; the MRF
    stage refusing autograd on the card."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.models.hifigan import (
        load_vocoder_params, make_vocoder_fn, stage_params,
    )
    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import (
        fused_mrf_stage, mrf_conv, prepare_stage_weights,
    )
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

    npz = ckpt_dir / "vocoder.npz"
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        cli.main(["evaluate-vocoder", str(config_path), "-v", str(npz)])
    eval_s = time.time() - t0
    report = json.loads(out.getvalue())
    check(report["n"] == N_VOC_VAL and all(math.isfinite(report[k]) for k in
                                           ("mel_l1", "si_sdr_db", "stoi", "pesq_proxy")),
          f"evaluate-vocoder: {report}")
    log(f"evaluate-vocoder on step={VOC_RESUME}'s vocoder.npz: {report} in {eval_s:.1f} s")

    params, vcfg, vstep = load_vocoder_params(npz)
    check(vstep == VOC_RESUME, f"vocoder.npz global_step {vstep}")
    mels = [np.load(p).T[None] for p in sorted((workdir / "vcorpus" / "spec").glob("*.npy"))
            [:N_VOC_VAL]]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fused = make_vocoder_fn(params, vcfg, fused=True)
        unfused = make_vocoder_fn(params, vcfg, fused=False)
        mrf_conv.launches = 0
        wf = [fused(m)[0] for m in mels]
        torch.cuda.synchronize()
        launches = mrf_conv.launches
        wu = [unfused(m)[0] for m in mels]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    want = MRF_LAUNCHES * VOC_MRF_STAGES * len(mels)
    check(launches == want, f"mrf_conv launched {launches} times vocoding {len(mels)} mels, "
                            f"want {want}")
    rels = [float(np.linalg.norm(f - u) / np.linalg.norm(u)) for f, u in zip(wf, wu)]
    check(max(rels) <= MRF_LIMIT["float32"], f"fused against unfused vocoding rel-L2 {rels}")
    log(f"trained vocoder: {len(mels)} validation mels fused against unfused (f32, TF32 off) "
        f"rel-L2 max {max(rels):.2e}; mrf_conv {launches} launches "
        f"({MRF_LAUNCHES} x {VOC_MRF_STAGES} stages a mel)")

    syn = Synthesizer.from_checkpoint(workdir / "model.ckpt", vocoder_path=npz)
    result = syn.synthesize(["the trained vocoder speaks to you."])
    wav, mel = result.wavs[0], result.mels[0]
    check(wav.ndim == 1 and wav.size == mel.shape[0] * vcfg.total_upsampling
          and bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0,
          f"the Synthesizer with the trained vocoder gave {wav.shape} for {mel.shape}")

    x = torch.randn(1, 300, 128, device="cuda", requires_grad=True)
    dev_params = {k: torch.as_tensor(v).cuda() for k, v in params.items()}
    flat = prepare_stage_weights(stage_params(dev_params, 1, 3), (3, 7, 11), ((1, 3, 5),) * 3,
                                 torch.float32)
    before = mrf_conv.launches
    try:
        fused_mrf_stage(x, flat)
        refused = False
    except RuntimeError as e:
        refused = "no backward" in str(e)
    check(refused and mrf_conv.launches == before,
          "fused_mrf_stage under autograd did not raise before launching")
    log(f"trained vocoder: the Synthesizer spoke {wav.size} samples; fused_mrf_stage under "
        "autograd raised before launching")
    return dict(report=report, eval_s=eval_s, launches=launches, fused_rel=max(rels))


# -- phase 24: preprocess a wav corpus, then train on it ------------------------

N_WAVS = 128  # utterances of 1-11 s in the main source
N_STEREO = 16  # 44.1 kHz stereo files of 1-4 s under sox effects
STEREO_EFFECTS = [["channels", "1"], ["rate", "22050"]]
PRE_STEPS = 4
PRE_CPUS = 4


def corpus_wav(rng, seconds: float, sr: int = 22050):
    """Speech-like audio: a harmonic tone (6 partials) on a 90-260 Hz pitch
    with 4-7 Hz vibrato under a syllable envelope, cut by 0.1-0.3 s silences
    and 50-150 ms noise bursts, peaking at 0.5."""
    import numpy as np

    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 260) * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase) / h for h in range(1, 7))
    x = x * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6.3)))
    for _ in range(int(seconds)):
        a = int(rng.integers(0, n))
        x[a: a + int(rng.uniform(0.1, 0.3) * sr)] = 0.0
        b = int(rng.integers(0, n))
        m = len(x[b: b + int(rng.uniform(0.05, 0.15) * sr)])
        x[b: b + m] = 0.4 * rng.standard_normal(m)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def _sentence(rng, n_chars: int) -> str:
    words = []
    while len(" ".join(words)) < n_chars:
        words.append(str(rng.choice(WORDS)))
    return " ".join(words)[:n_chars].strip()


def write_wav_corpus(root: Path, rng) -> list:
    """The main source (N_WAVS wavs of 1-11 s, one of 12 s and one of 0.3 s
    that the length filter drops) and the stereo source, with filelists of
    about 12 characters a second; returns the config's source_data."""
    import numpy as np
    from scipy.io import wavfile

    from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import save_wav
    from fastspeech2_lightning_tpu_torch.utils import write_filelist

    rows = []
    lengths = [float(rng.uniform(1.0, 11.0)) for _ in range(N_WAVS)] + [12.0, 0.3]
    for i, seconds in enumerate(lengths):
        save_wav(root / "wavs" / f"w{i:03d}.wav", corpus_wav(rng, seconds), 22050)
        rows.append({"basename": f"w{i:03d}", "characters": _sentence(rng, max(4, int(12 * seconds)))})
    write_filelist(rows, root / "wavs.psv")
    (root / "stereo").mkdir()
    rows = []
    for i in range(N_STEREO):
        seconds = float(rng.uniform(1.0, 4.0))
        left, right = corpus_wav(rng, seconds, 44100), corpus_wav(rng, seconds, 44100)
        wavfile.write(root / "stereo" / f"s{i:02d}.wav", 44100,
                      (np.stack([left, right], 1) * 32767).astype(np.int16))
        rows.append({"basename": f"s{i:02d}", "characters": _sentence(rng, int(12 * seconds))})
    write_filelist(rows, root / "stereo.psv")
    # absolute: a relative data_dir or filelist is read from the working
    # directory, as in the JAX package
    return [{"label": "wavs", "data_dir": str(root / "wavs"), "filelist": str(root / "wavs.psv")},
            {"label": "stereo", "data_dir": str(root / "stereo"),
             "filelist": str(root / "stereo.psv"), "sox_effects": STEREO_EFFECTS}]


def _preprocess_cli(config_path: Path, *flags) -> float:
    """The port's preprocess CLI in a subprocess; its wall in seconds."""
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", PORT, "preprocess", str(config_path), *flags],
                         cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    check(out.returncode == 0, f"preprocess {flags} exited {out.returncode}: "
                               f"{out.stderr[-3000:]}")
    log(f"preprocess {' '.join(flags)}: {out.stdout.strip().splitlines()[-1]}")
    return wall


def _tree_files(root: Path, kind: str) -> dict:
    return {p.name.split("--")[0]: p for p in (root / kind).glob("*")}


def phase_preprocess(workdir: Path) -> dict:
    """Phase 24: a seeded wav corpus through the port's ``preprocess`` CLI,
    on the host (4 workers) and with the spectral pass on the card; the two
    trees held against each other; then 4 train steps on the host tree."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.dataset import BucketedLoader, load_datasets
    from fastspeech2_lightning_tpu_torch.preprocessing.features import batched_mel_energy_torch
    from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import DEVICE_BATCH, Preprocessor
    from fastspeech2_lightning_tpu_torch.text.lookups import lookuptables_from_config
    from fastspeech2_lightning_tpu_torch.utils import load_filelist

    root = workdir / "wav_corpus"
    root.mkdir()
    t0 = time.time()
    sources = write_wav_corpus(root, np.random.default_rng(SEED + 24))
    n_kept = N_WAVS + N_STEREO
    cfg = model_config("bfloat16")
    cfg["preprocessing"].update(save_dir="pre_host", source_data=sources)
    cfg["training"].update(batch_size=16, training_filelist="pre_host/training_filelist.psv",
                           validation_filelist="pre_host/validation_filelist.psv")
    cfg["training"]["logger"].update(save_dir="logs", name="smoke", version="preprocessed")
    config_path = root / "config.json"
    config_path.write_text(json.dumps(cfg))
    log(f"preprocess: {N_WAVS + 2} wavs of 0.3-12 s and {N_STEREO} stereo 44.1 kHz wavs "
        f"written in {time.time() - t0:.1f} s")

    walls = {"host": _preprocess_cli(config_path, "--host-spec", "--cpus", str(PRE_CPUS)),
             "device": _preprocess_cli(config_path, "--on-device-spec", "--cpus",
                                       str(PRE_CPUS), "-c", "preprocessing.save_dir=pre_dev")}
    host, dev = root / "pre_host", root / "pre_dev"
    n_train = int(n_kept * 0.9)
    for tree in (host, dev):
        rows = [load_filelist(tree / f"{s}_filelist.psv") for s in ("training", "validation")]
        check((len(rows[0]), len(rows[1])) == (n_train, n_kept - n_train),
              f"{tree.name}: {len(rows[0])} + {len(rows[1])} utterances, want {n_train} + "
              f"{n_kept - n_train}")
    for name in ("training_filelist.psv", "validation_filelist.psv"):
        check((host / name).read_bytes() == (dev / name).read_bytes(),
              f"{name} differs between the host and the device runs")
    kept = {r["basename"] for s in ("training", "validation")
            for r in load_filelist(host / f"{s}_filelist.psv")}
    check(len(kept) == n_kept and f"w{N_WAVS:03d}" not in kept and f"w{N_WAVS + 1:03d}" not in kept,
          "the length filter")
    for tree in (host, dev):
        for kind in ("audio", "spec", "attn", "text", "pfs", "pitch", "energy"):
            files = _tree_files(tree, kind)
            check(set(files) == kept and len(list((tree / kind).iterdir())) == n_kept,
                  f"{tree.name}/{kind}: {len(files)} artifacts for {n_kept} utterances")
    spec_h, spec_d = _tree_files(host, "spec"), _tree_files(dev, "spec")
    energy_h, energy_d = _tree_files(host, "energy"), _tree_files(dev, "energy")
    pitch_h, attn_h = _tree_files(host, "pitch"), _tree_files(host, "attn")
    worst = {"spec": 0.0, "energy": 0.0}
    n_frames = {}
    for b in sorted(kept):
        mel = np.load(spec_h[b])
        T = n_frames[b] = mel.shape[1]
        check(mel.shape[0] == 80 and np.load(pitch_h[b]).shape == (T,)
              and np.load(energy_h[b]).shape == (T,) and np.load(attn_h[b]).shape[0] == T,
              f"{b}: spec, pitch, energy and prior disagree in frames")
        for kind, (a, d) in (("spec", (mel, np.load(spec_d[b]))),
                             ("energy", (np.load(energy_h[b]), np.load(energy_d[b])))):
            check(a.shape == d.shape, f"{b}: {kind} {a.shape} on the host, {d.shape} on the card")
            worst[kind] = max(worst[kind], float(np.abs(a - d).max()))
    # the JAX package's own tolerances for its device pass against its host pass
    check(worst["spec"] <= 2e-2 and worst["energy"] <= 1e-1,
          f"the card's spec and energy against the host's: max-abs {worst}")
    stats = json.loads((host / "stats.json").read_text())
    check(all(math.isfinite(v) for k in ("pitch", "energy") for v in stats[k].values()),
          f"stats.json {stats}")
    for kind, files in (("pitch", pitch_h), ("energy", energy_h)):
        v = np.concatenate([np.load(p) for p in files.values()])
        v = v[v != 0]
        check(abs(float(v.mean())) < 1e-3 and abs(float(v.std()) - 1.0) < 1e-3,
              f"{kind} not z-normalized: mean {v.mean()}, std {v.std()}")
    audio_s = sum(n_frames.values()) * 256 / 22050

    # the device pass's batch: 16 utterances at the corpus's top bucket
    config = FastSpeech2Config.from_file(config_path)
    a = config.preprocessing.audio
    longest = max((b for b in kept if b.startswith("w")), key=lambda b: n_frames[b])
    _, batch = next(Preprocessor(config).device_batches(
        [({"basename": longest}, root / "wavs", [])] * DEVICE_BATCH))
    x = torch.from_numpy(batch).cuda()
    args = (a.input_sampling_rate, a.n_fft, a.fft_hop_size, a.fft_window_size, a.n_mels,
            a.f_min, a.f_max)
    pass_ms = time_ms(lambda: [t.cpu() for t in batched_mel_energy_torch(
        torch.from_numpy(batch).cuda(), *args)], warmup=2, iters=10)
    pass_dev = device_ms(lambda: batched_mel_energy_torch(x, *args), iters=10)
    log(f"preprocess: {n_kept} utterances, {audio_s:.1f} s of audio; host pass ({PRE_CPUS} "
        f"workers) {walls['host']:.1f} s wall, {n_kept / walls['host']:.2f} utterances/s; "
        f"device pass {walls['device']:.1f} s wall, {n_kept / walls['device']:.2f} "
        f"utterances/s; the card's batch of {DEVICE_BATCH} x {batch.shape[1]} samples "
        f"{pass_ms:.3f} ms with its copies ({pass_dev:.4f} device); card against host max-abs "
        f"spec {worst['spec']:.3e}, energy {worst['energy']:.3e}")

    _, val_ds = load_datasets(config, *lookuptables_from_config(config))
    val_batches = len(BucketedLoader(val_ds, min(16, max(len(val_ds), 1)),
                                     n_buckets=config.training.bucket_count,
                                     max_mel_length=config.model.max_mel_length))
    t0 = time.time()
    tl, vl = _train_and_validation_launches(
        lambda: cli.main(["train", str(config_path), "--max-steps", str(PRE_STEPS)]))
    train_s = time.time() - t0
    log_dir = root / "logs" / "smoke" / "preprocessed"
    rows = _rows(log_dir / "train_log.jsonl")
    check(len(rows) == PRE_STEPS and all(math.isfinite(r[k]) for r in rows for k in LOSS_KEYS),
          f"training on the preprocessed tree: {rows}")
    want_t = {"attention_fwd": 8 * PRE_STEPS, "attention_bwd": 8 * PRE_STEPS,
              "mas_width1": PRE_STEPS, "ctc_alpha": 0, "ctc_alpha_beta": PRE_STEPS,
              "ctc_grad": PRE_STEPS}
    want_v = {"attention_fwd": 8 * val_batches, "attention_bwd": 0, "mas_width1": val_batches,
              "ctc_alpha": val_batches, "ctc_alpha_beta": 0, "ctc_grad": 0}
    check(tl == want_t and vl == want_v, f"launches training {tl}, validation {vl}; predicted "
                                         f"{want_t}, {want_v}")
    step_dir = log_dir / "checkpoints" / f"step={PRE_STEPS}"
    check((step_dir / "model.ckpt").is_file(), f"no checkpoint at {step_dir}")
    for r in rows:
        log(f"train on the preprocessed tree, step {r['step']}: B x L x T = "
            f"{' x '.join(map(str, r['shape']))}, {r['ms']:.1f} ms, total {r['total']:.4f}")
    log(f"train on the preprocessed tree: {PRE_STEPS} steps in {train_s:.1f} s; launches "
        f"training {tl}, validation {vl}")
    return dict(config_path=config_path, step_dir=step_dir, kept=n_kept, audio_s=audio_s,
                host_s=walls["host"], device_s=walls["device"],
                utterances_per_s={k: n_kept / w for k, w in walls.items()},
                device_batch={"shape": list(batch.shape), "ms": pass_ms, "device_ms": pass_dev},
                card_vs_host=worst, train_launches=tl, validation_launches=vl,
                step_ms=[r["ms"] for r in rows])


# -- phase 25: check-data with per-utterance scores -----------------------------

CHECK_COUNTERS = TRAIN_COUNTERS + ("mrf_conv",)
N_CHECK_CVC = 8


class CheckDataProbe:
    """Wraps the kernels and the scoring while ``check-data`` runs: keeps
    the inputs of the first ``attention_fwd`` call at an odd length, of the
    first ``mas_width1`` and of the first ``ctc_alpha``, and times every
    teacher-forced forward and loss (the card synchronized around each) and
    the scoring run as a whole."""

    def __init__(self):
        self.captured, self.forward, self.loss, self.scoring = {}, [], [], []

    def __enter__(self):
        from fastspeech2_lightning_tpu_torch.models import conformer, fastspeech2
        from fastspeech2_lightning_tpu_torch.models import variance_adaptor
        from fastspeech2_lightning_tpu_torch.ops import ctc
        from fastspeech2_lightning_tpu_torch.synthesis import synthesize

        self._saved = [(conformer, "attention_fwd", conformer.attention_fwd),
                       (variance_adaptor, "mas_width1", variance_adaptor.mas_width1),
                       (ctc, "ctc_forward_sum", ctc.ctc_forward_sum),
                       (synthesize, "compute_loss", synthesize.compute_loss),
                       (fastspeech2.FastSpeech2, "forward_teacher_forced",
                        fastspeech2.FastSpeech2.forward_teacher_forced),
                       (synthesize, "synthesize_items", synthesize.synthesize_items)]
        real_att, real_mas, real_sum, real_loss, real_tf, real_items = (
            s[2] for s in self._saved)
        captured = self.captured

        def attention(q, k, v, bias, scale, *args, **kwargs):
            if q.shape[2] % 2 and "attention_fwd" not in captured:
                captured["attention_fwd"] = (q.clone(), k.clone(), v.clone(), bias.clone(),
                                             scale)
            return real_att(q, k, v, bias, scale, *args, **kwargs)

        def mas(log_attn, in_lens, out_lens):
            captured.setdefault("mas_width1", (log_attn.clone(), in_lens.clone(),
                                               out_lens.clone()))
            return real_mas(log_attn, in_lens, out_lens)

        def forward_sum(logprobs, in_lens, out_lens):  # ctc_alpha's inputs
            captured.setdefault("ctc_alpha", (logprobs.clone(), out_lens.clone()))
            return real_sum(logprobs, in_lens, out_lens)

        def teacher_forced(model, *args, **kwargs):
            return _timed(real_tf, self.forward)(model, *args, **kwargs)

        conformer.attention_fwd = attention
        variance_adaptor.mas_width1 = mas
        ctc.ctc_forward_sum = forward_sum
        synthesize.compute_loss = _timed(real_loss, self.loss)
        synthesize.synthesize_items = _timed(real_items, self.scoring)
        fastspeech2.FastSpeech2.forward_teacher_forced = teacher_forced
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _check_data_cli(argv: list) -> dict:
    """check-data in-process with every counter set to 0 just before it and
    read just after; the wall and the launches."""
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import mrf_conv

    counters = {**_counters(), "mrf_conv": mrf_conv}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    with contextlib.redirect_stderr(io.StringIO()):  # the estimates' note
        cli.main(["check-data", *argv])
    torch.cuda.synchronize()
    return dict(wall_s=time.time() - t0, launches={k: fn.launches for k, fn in counters.items()})


def phase_check_data(workdir: Path, pre: dict) -> dict:
    """Phase 25: ``check-data`` on phase 24's tree with its step=4/ scoring
    every utterance on the card, the objective estimates and the thorough
    clipping count; the launches around it; kernels A (p 0), B and C's
    alpha chain against their plain versions on inputs the run gave them;
    then a 2+2-layer f32 model scoring 8 utterances on the card and on the
    CPU."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint
    from fastspeech2_lightning_tpu_torch.ops import ctc
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, attention_reference
    from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference
    from fastspeech2_lightning_tpu_torch.utils import load_filelist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    config_path, n = pre["config_path"], pre["kept"]
    out = workdir / "checked"
    with CheckDataProbe() as probe:
        run = _check_data_cli([str(config_path), "--model-path", str(pre["step_dir"]), "-o",
                               str(out), "--objective-evaluation", "--clip-detection"])
    rows = json.loads((out / "checked-data.json").read_text())
    check(len(rows) == n and all(math.isfinite(r[k]) for r in rows for k in
                                 ("pitch_mean", "energy_mean", "stoi", "si_sdr", "duration")),
          f"checked-data.json: {len(rows)} rows for {n} utterances")
    scores = load_filelist(out / f"scores-{PRE_STEPS}.psv")
    losses = [k for k in scores[0] if k.endswith("_loss")]
    check(len(scores) == n and {r["basename"] for r in scores} == {r["basename"] for r in rows},
          f"scores-{PRE_STEPS}.psv: {len(scores)} rows for {n} utterances")
    check({"total_loss", "spec_loss", "postnet_loss", "duration_loss", "attn_ctc_loss"}
          <= set(losses) and all(math.isfinite(float(r[k])) for r in scores for k in losses),
          f"scores columns {list(scores[0])}")
    key = [(-float(r["total_loss"]), float(r["trigram_coverage_score"])) for r in scores]
    check(key == sorted(key), "scores are not sorted by (-total_loss, trigram coverage)")
    want = {k: 0 for k in CHECK_COUNTERS}
    want.update(attention_fwd=8 * n, mas_width1=n, ctc_alpha=n)
    check(run["launches"] == want, f"check-data launches {run['launches']}, predicted {want}")
    check(len(probe.forward) == len(probe.loss) == n and len(probe.scoring) == 1,
          f"{len(probe.forward)} forwards and {len(probe.loss)} losses timed for {n}")
    fwd, loss = sum(probe.forward) / n, sum(probe.loss) / n
    scoring_ms = probe.scoring[0]
    host_ms = scoring_ms / n - fwd - loss
    log(f"check-data: {n} rows, {len(scores)} scores ({', '.join(losses)}) in "
        f"{run['wall_s']:.1f} s, of which scoring {scoring_ms / 1e3:.1f} s; launches "
        f"{run['launches']}; a scored utterance {scoring_ms / n:.2f} ms: forward {fwd:.2f}, "
        f"loss {loss:.2f}, the host's share {host_ms:.2f} (batching, copies, writer)")

    q, k, v, bias, scale = probe.captured["attention_fwd"]
    max_abs, rel = errors(attention_fwd(q, k, v, bias, scale),
                          attention_reference(q.float(), k.float(), v.float(), bias, scale))
    check(rel <= 2e-2, f"attention_fwd at the check-data shape {list(q.shape)}: rel-L2 {rel}")
    la, in_lens, out_lens = probe.captured["mas_width1"]
    hard, dur = mas_width1(la, in_lens, out_lens)
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    check(torch.equal(hard, want_hard) and torch.equal(dur, want_dur),
          f"mas_width1 at the check-data shape {list(la.shape)}: differs from the plain version")
    lp, lens = probe.captured["ctc_alpha"]
    alphas, want_alphas = ctc.ctc_alpha(lp, lens), ctc.ctc_alpha_reference(lp, lens)
    live = want_alphas > 0.5 * ctc.NEG_INF
    alpha_abs = float((alphas - want_alphas)[live].abs().max())
    alpha_scale = float(want_alphas[live].abs().max())
    check(torch.equal(alphas > 0.5 * ctc.NEG_INF, live) and alpha_abs <= 1e-5 * alpha_scale,
          f"ctc_alpha at the check-data shape {list(lp.shape)}: max-abs {alpha_abs} of "
          f"{alpha_scale}")
    log(f"check-data kernels at the path's shapes: attention_fwd {list(q.shape)} "
        f"{str(q.dtype).split('.')[-1]} rel-L2 {rel:.3e} (max-abs {max_abs:.3e}); mas_width1 "
        f"{list(la.shape)} bit-exact; ctc_alpha {list(lp.shape)} max-abs {alpha_abs:.3e}")

    # card against CPU: a 2+2-layer f32 model scores 8 utterances on both
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config("float32")
    for part in ("encoder", "decoder"):
        cfg["model"][part]["layers"] = 2
    cfg["preprocessing"]["save_dir"] = str(config_path.parent / "pre_host")
    ckpt = write_checkpoint(workdir / "check_small.ckpt",
                            random_state_dict(cfg, np.random.default_rng(SEED + 25)), cfg,
                            STATS, lang2id={"default": 0}, speaker2id={"default": 0})
    lines = (config_path.parent / "pre_host" / "training_filelist.psv").read_text().splitlines()
    small = workdir / "check_cvc.psv"
    small.write_text("\n".join(lines[: N_CHECK_CVC + 1]) + "\n")
    scored = {}
    with SharedBins() as bins:
        for dev in ("cpu", "cuda"):
            with bins.on(dev):
                _check_data_cli([str(config_path), "-f", str(small), "--no-calculate-stats",
                                 "--model-path", str(ckpt), "-o", str(workdir / f"cvc_{dev}"),
                                 "--device", dev])
            scored[dev] = {r["basename"]: r for r in load_filelist(workdir / f"cvc_{dev}" /
                                                              "scores-0.psv")}
    flips = bins.held()
    check(sorted(scored["cuda"]) == sorted(scored["cpu"]) and len(scored["cpu"]) == N_CHECK_CVC,
          "card and CPU scored different utterances")
    worst = 0.0
    for b, r in scored["cpu"].items():
        for k in losses:
            a, c = float(scored["cuda"][b][k]), float(r[k])
            worst = max(worst, abs(a - c) / max(abs(c), 1e-6))
    check(worst <= 1e-4, f"card against CPU scores: rel {worst} > 1e-4")
    log(f"card vs CPU check-data scores (f32, TF32 off, 2+2 layers, {N_CHECK_CVC} utterances): "
        f"losses rel {worst:.3e}; pitch and energy buckets differing at an edge {flips}")
    return dict(rows=len(rows), scores=len(scores), wall_s=run["wall_s"],
                launches=run["launches"], ms_per_utterance=scoring_ms / n, forward_ms=fwd,
                loss_ms=loss, host_ms=host_ms, card_vs_cpu_rel=worst,
                shapes={"attention_fwd": list(q.shape), "mas_width1": list(la.shape),
                        "ctc_alpha": list(lp.shape)},
                max_abs_err={"attention_fwd": max_abs, "ctc_alpha": alpha_abs})


# -- phase 26: the operator's tools -----------------------------------------------

BENCH_WARMUP = 5
BENCH_REPS = 50
BENCH_TRIALS = 5  # time_chained's
BENCH_LINE = re.compile(
    r"Average forward pass for (\w+) duration after (\d+) repetitions: ([\d.]+) ms "
    r"Standard Deviation: ([\d.]+) \(best ([\d.]+) ms, ([\d.]+) TFLOP/call, MFU ([\d.]+)%; "
    r"forced-completion chained timing\)")


class KernelInputs:
    """Keeps the inputs of the first attention_fwd call at the largest T
    and of the first mas_width1 call while a run goes through the model."""

    def __init__(self):
        self.captured = {}

    def __enter__(self):
        from fastspeech2_lightning_tpu_torch.models import conformer, variance_adaptor

        self._saved = [(conformer, "attention_fwd", conformer.attention_fwd),
                       (variance_adaptor, "mas_width1", variance_adaptor.mas_width1)]
        real_att, real_mas = (s[2] for s in self._saved)
        captured = self.captured

        def attention(q, k, v, bias, scale, *args, **kwargs):
            have = captured.get("attention_fwd")
            if have is None or q.shape[2] > have[0].shape[2]:
                captured["attention_fwd"] = (q.clone(), k.clone(), v.clone(), bias.clone(), scale)
            return real_att(q, k, v, bias, scale, *args, **kwargs)

        def mas(log_attn, in_lens, out_lens):
            captured.setdefault("mas_width1", (log_attn.clone(), in_lens.clone(),
                                               out_lens.clone()))
            return real_mas(log_attn, in_lens, out_lens)

        conformer.attention_fwd = attention
        variance_adaptor.mas_width1 = mas
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _benchmark_cli(config_path: Path, mode: str, *flags) -> dict:
    """The port's ``benchmark`` in-process with every counter set to 0 just
    before it and read just after; its printed lines and parsed fields."""
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import mrf_conv

    counters = {**_counters(), "mrf_conv": mrf_conv}
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        cli.main(["benchmark", str(config_path), "--benchmark-type", mode, *flags])
    torch.cuda.synchronize()
    wall = time.time() - t0
    lines = out.getvalue().strip().splitlines()
    m = BENCH_LINE.fullmatch(lines[-1]) if lines else None
    check(m is not None and m[1] == mode, f"benchmark {mode} printed {lines}")
    mean, std, best, tflop, mfu = map(float, m.groups()[2:])
    return dict(lines=lines, wall_s=wall, mean_ms=mean, std_ms=std, best_ms=best,
                tflop_per_call=tflop, mfu_percent=mfu,
                launches={k: fn.launches for k, fn in counters.items()})


def _trace_kernels(trace: Path) -> dict:
    """The trace's device kernels by name: events and summed microseconds."""
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            row = kernels.setdefault(e["name"], [0, 0.0])
            row[0] += 1
            row[1] += float(e.get("dur", 0.0))
    return dict(events=len(events), kernels=kernels)


def phase_tools(workdir: Path, pre: dict) -> dict:
    """Phase 26: ``benchmark`` at full width (phase 11's config: the default
    model in bf16, B 16) in both modes, the launches counted around each run
    (training: 8 attention_fwd and 1 mas_width1 a call, inference: 8
    attention_fwd a call, nothing else), the printed MFU in (0, 100 %], A (p
    0) and B against their plain versions on inputs the runs gave them, a
    run with ``--profile-dir``; ``average-checkpoints --last 2`` and
    ``--use-ema`` on phase 11's step directories (one step more makes the
    second), the average served for one request; ``export-checkpoint`` of
    it synthesizing the step directory's mel; ``doctor`` on phase 24's
    config with every kernel row OK."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, attention_reference
    from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference
    from fastspeech2_lightning_tpu_torch.serving import serve
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
    from fastspeech2_lightning_tpu_torch.training.checkpoint import load_train_state, read_meta

    config_path = workdir / "config.json"  # phase 11's
    flags = ("--warmup-reps", str(BENCH_WARMUP), "--repetitions", str(BENCH_REPS))
    calls = 1 + BENCH_WARMUP + BENCH_TRIALS * BENCH_REPS  # the FLOP count's call first
    runs, captured = {}, {}
    for mode in ("training", "inference"):
        with KernelInputs() as probe:
            runs[mode] = run = _benchmark_cli(config_path, mode, *flags)
        captured[mode] = probe.captured
        want = {k: 0 for k in CHECK_COUNTERS}
        want.update(attention_fwd=8 * calls, mas_width1=calls if mode == "training" else 0)
        check(run["launches"] == want,
              f"benchmark {mode}: launches {run['launches']}, predicted {want} ({calls} calls)")
        check(0.0 < run["mfu_percent"] <= 100.0 and run["tflop_per_call"] > 0.0,
              f"benchmark {mode}: MFU {run['mfu_percent']} %, {run['tflop_per_call']} TFLOP")
        log(f"benchmark {mode}: {run['lines'][-1]} ({run['wall_s']:.1f} s wall; launches "
            f"{run['launches']})")

    kernels = {"attention_fwd": {}}
    for mode in ("training", "inference"):
        q, k, v, bias, scale = captured[mode]["attention_fwd"]
        max_abs, rel = errors(attention_fwd(q, k, v, bias, scale),
                              attention_reference(q.float(), k.float(), v.float(), bias, scale))
        check(rel <= 2e-2,
              f"attention_fwd at benchmark {mode}'s shape {list(q.shape)}: rel-L2 {rel}")
        kernels["attention_fwd"][mode] = dict(shape=list(q.shape), max_abs_err=max_abs,
                                              rel_l2=rel,
                                              masked_keys=float((bias < 0).float().mean()))
    la, in_lens, out_lens = captured["training"]["mas_width1"]
    hard, dur = mas_width1(la, in_lens, out_lens)
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    check(torch.equal(hard, want_hard) and torch.equal(dur, want_dur),
          f"mas_width1 at the benchmark shape {list(la.shape)}: differs from the plain version")
    kernels["mas_width1"] = dict(shape=list(la.shape), max_abs_err=0.0)
    att = kernels["attention_fwd"]
    log("benchmark kernels: attention_fwd " + "; ".join(
        f"{mode}'s decoder {row['shape']} ({row['masked_keys']:.3f} of the keys masked) "
        f"rel-L2 {row['rel_l2']:.3e} (max-abs {row['max_abs_err']:.3e})"
        for mode, row in att.items()) + f"; mas_width1 {list(la.shape)} bit-exact")

    prof_dir = workdir / "bench_profile"
    prof = _benchmark_cli(config_path, "inference", "--warmup-reps", "2", "--repetitions", "5",
                          "--profile-dir", str(prof_dir))
    trace = prof_dir / "trace.json"
    check(prof["lines"][0] == f"Wrote profiler trace to {trace}" and trace.is_file(),
          f"benchmark --profile-dir printed {prof['lines']}")
    prof_calls = 2 + BENCH_TRIALS * 5  # the profiler starts after the FLOP count's call
    check(prof["launches"]["attention_fwd"] == 8 * (1 + prof_calls),
          f"benchmark --profile-dir: launches {prof['launches']} for 1 + {prof_calls} calls")
    held = _trace_kernels(trace)
    top = sorted(held["kernels"].items(), key=lambda kv: -kv[1][1])
    busy_ms = sum(us for _, us in held["kernels"].values()) / 1e3 / prof_calls
    log(f"benchmark trace: {held['events']} events, {len(held['kernels'])} kernel names, "
        f"{sum(n for n, _ in held['kernels'].values())} kernel events; the card busy "
        f"{busy_ms:.3f} ms a call (kernels summed over the {prof_calls} calls) against the "
        f"profiled run's {prof['mean_ms']:.3f} ms a timed call")
    for name, (n, us) in top[:12]:
        log(f"benchmark trace kernel {name[:70]}: {n} events, {us / 1e3:.3f} ms")

    # average-checkpoints on phase 11's step directories: one step more, keeping the
    # newest three, makes a second
    ckpt_dir = workdir / "logs" / "smoke" / "train" / "checkpoints"
    newest = max(int(p.name.split("=")[1]) for p in ckpt_dir.glob("step=*"))
    cli.main(["train", str(config_path), "--max-steps", str(newest + 1), "-c",
              "training.save_top_k_ckpts=3"])
    steps = sorted(int(p.name.split("=")[1]) for p in ckpt_dir.glob("step=*"))
    check(len(steps) >= 2 and steps[-1] == newest + 1, f"step directories {steps}")
    avg, avg_ema = workdir / "averaged", workdir / "averaged_ema"
    cli.main(["average-checkpoints", str(ckpt_dir), "--last", "2", "-o", str(avg)])
    cli.main(["average-checkpoints", str(ckpt_dir), "-n", "2", "--use-ema", "-o", str(avg_ema)])
    for out in (avg, avg_ema):
        meta = read_meta(out)
        check(meta["metrics"] == {} and len(meta["averaged_from"]) == 2
              and meta["global_step"] == steps[-1] and load_train_state(out)["ema"] is None,
              f"{out.name}: meta {meta['averaged_from']}, {meta['global_step']}")
    a, b = (torch.load(ckpt_dir / f"step={s}" / "model.ckpt", map_location="cpu",
                       weights_only=True)["state_dict"] for s in steps[-2:])
    got = torch.load(avg / "model.ckpt", map_location="cpu", weights_only=True)["state_dict"]
    name = "mel_linear.weight"
    check(torch.equal(got[name], ((a[name].double() + b[name].double()) / 2).float())
          and torch.equal(got["variance_adaptor.pitch_bins"], b["variance_adaptor.pitch_bins"]),
          "the averaged parameters or the newest buffers")
    server = serve(avg_ema, port=0, max_batch=BATCH)
    check(server.synthesizer.device.type == "cuda", "the average did not load on the card")
    server.start()
    try:
        status, body, seconds = _post(server.address, {"text": "the averaged model speaks.",
                                                       "format": "mel"})
    finally:
        server.shutdown()
    mel = np.load(io.BytesIO(body))
    check(status == 200 and mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all(),
          f"serving the averaged checkpoint: {status}, {mel.shape}")
    log(f"average-checkpoints: steps {steps[-2:]} averaged (params and EMA); the EMA average "
        f"served one request: {mel.shape[0]} frames in {seconds:.3f} s")

    exported = workdir / "export" / "averaged.ckpt"
    cli.main(["export-checkpoint", str(avg_ema), "-o", str(exported)])
    texts = ["the exported model speaks."]
    from_dir = Synthesizer.from_checkpoint(avg_ema).synthesize(texts).mels[0]
    from_ckpt = Synthesizer.from_checkpoint(exported).synthesize(texts).mels[0]
    check(np.array_equal(from_dir, from_ckpt),
          f"export-checkpoint: the .ckpt's mel {from_ckpt.shape} differs from the step "
          f"directory's {from_dir.shape}")
    log(f"export-checkpoint: {exported.name} synthesizes the step directory's mel "
        f"({from_dir.shape[0]} frames, equal)")

    doc = subprocess.run([sys.executable, "-m", PORT, "doctor", str(pre["config_path"]),
                          "--device-timeout", "120"], cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    rows = doc.stdout.strip().splitlines()
    for line in rows:
        log(f"doctor: {line}")
    kernel_rows = [r for r in rows if r[2:].split(" ")[0].endswith(".cu")]
    check(doc.returncode == 0 and len(kernel_rows) == 5
          and all(r.startswith("✓") for r in kernel_rows),
          f"doctor exited {doc.returncode}: {doc.stdout[-2000:]} {doc.stderr[-2000:]}")
    return dict(benchmark={m: {k: r[k] for k in ("mean_ms", "std_ms", "best_ms",
                                                  "tflop_per_call", "mfu_percent", "launches",
                                                  "wall_s")} for m, r in runs.items()},
                calls=calls, kernels=kernels,
                trace=dict(events=held["events"], busy_ms_per_call=busy_ms,
                           mean_ms=prof["mean_ms"], kernels=dict(top[:20])),
                averaged_steps=steps[-2:], served_frames=int(mel.shape[0]),
                doctor=rows)


# -- phase 27: export-serving and .fs2x ----------------------------------------------------


YAML_TIMED = 3  # validations with media and without, in turns


def _yaml_scalar(x) -> str:
    """A scalar as YAML 1.1 reads it back: strings double-quoted with JSON's
    escapes (non-ASCII as \\uXXXX), floats always with a dot."""
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        if math.isnan(x):
            return ".nan"
        if math.isinf(x):
            return ".inf" if x > 0 else "-.inf"
        r = repr(x)
        return r if "." in r or "e" not in r else r.replace("e", ".0e")
    return json.dumps(x)


def _yaml_lines(obj, indent: int = 0) -> list:
    """Block-style YAML of a dict or list: a list under a key at the key's
    indentation, as ``yaml.safe_dump`` writes it; empty containers in flow
    style."""
    pad = " " * indent
    lines = []
    items = obj.items() if isinstance(obj, dict) else ((None, v) for v in obj)
    for key, value in items:
        head = f"{pad}{key}:" if key is not None else f"{pad}-"
        nested = isinstance(value, (dict, list, tuple)) and len(value) > 0
        if not nested:
            empty = {dict: "{}", list: "[]", tuple: "[]"}.get(type(value))
            lines.append(f"{head} {empty or _yaml_scalar(value)}")
        elif key is not None and isinstance(value, dict):
            lines += [head] + _yaml_lines(value, indent + 2)
        elif key is not None:
            lines += [head] + _yaml_lines(list(value), indent)
        else:  # a collection as a sequence item opens on the dash's line
            sub = _yaml_lines(value if isinstance(value, dict) else list(value), indent + 2)
            lines += [f"{pad}- {sub[0][indent + 2:]}"] + sub[1:]
    return lines


def _audio_clip(events: list, tag: str) -> tuple:
    """(int16 samples, the Summary.Audio fields) of `tag`'s one clip."""
    from fastspeech2_lightning_tpu_torch.utils.tensorboard import wav_samples

    clips = [v["audio"] for e in events for v in e.get("summary", ()) if v["tag"] == tag]
    check(len(clips) == 1, f"{len(clips)} clips tagged {tag}")
    pcm, rate = wav_samples(clips[0]["encoded_audio_string"])
    check(rate == clips[0]["sample_rate"] and clips[0]["num_channels"] == 1
          and clips[0]["content_type"] == "audio/wav" and pcm.size == clips[0]["length_frames"],
          f"{tag}: {({k: v for k, v in clips[0].items() if k != 'encoded_audio_string'})}, "
          f"{pcm.size} samples at {rate}")
    return pcm, clips[0]


def _check_vocoded(events: list, tag: str, mel, vocoder, hop: int) -> float:
    """`tag`'s clip: PCM16 at the vocoder's rate, mel frames x hop samples,
    within one PCM16 step of the vocoder run again on `mel`. Returns the
    largest difference in PCM16 steps."""
    import numpy as np

    pcm, clip = _audio_clip(events, tag)
    again = vocoder.device_fn(mel).float().cpu().numpy()[0]
    want = np.round(np.clip(again.astype(np.float64), -1, 1) * 32767)
    diff = float(np.abs(pcm - want).max())
    check(clip["sample_rate"] == vocoder.sample_rate and pcm.size == mel.shape[1] * hop
          and diff <= 1 and int(np.abs(pcm).max()) > 0,
          f"{tag}: {pcm.size} samples at {clip['sample_rate']} for {mel.shape[1]} frames x "
          f"{hop} at {vocoder.sample_rate}; {diff} PCM16 steps from the vocoder again")
    return diff


def phase_yaml_media(workdir: Path, vocoder_npz: Path, smi: str) -> dict:
    """Phase 28 (see the module docstring)."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config, load_config_base_command
    from fastspeech2_lightning_tpu_torch.models.hifigan import load_vocoder_checkpoint
    from fastspeech2_lightning_tpu_torch.preprocessing.pipeline import load_wav, save_wav
    from fastspeech2_lightning_tpu_torch.training import loop
    from fastspeech2_lightning_tpu_torch.utils import plotting
    from fastspeech2_lightning_tpu_torch.utils.tensorboard import (
        crc_rate_mb_s, decode_png, read_events, scalars,
    )
    from fastspeech2_lightning_tpu_torch.yaml_reader import safe_load

    t_phase = time.time()
    json_path = workdir / "config.json"  # phase 11's
    cfg = json.loads(json_path.read_text())
    training = dict(cfg["training"])
    training.pop("vocoder_path")
    filelist = training.pop("training_filelist")
    contact = "fs2t smoke: the port reads its YAML config, \u0283 and all"
    main_lines = ["# phase 11's config as YAML; the training section in a partial",
                  "contact:",
                  '  contact_name: "fs2t smoke: the port reads its YAML config,',
                  '    \\u0283 and all"',  # a double-quoted string folded over two lines
                  "path_to_training_config_file: training.yaml",
                  "training:",
                  "  vocoder_path: " + _yaml_scalar(str(vocoder_npz.relative_to(workdir)))]
    main_lines += _yaml_lines({k: v for k, v in cfg.items() if k != "training"})
    partial_lines = ["training_filelist: >-", f"  {filelist}"] + _yaml_lines(training)
    yaml_path, partial_path = workdir / "config.yaml", workdir / "training.yaml"
    yaml_path.write_text("\n".join(main_lines) + "\n")
    partial_path.write_text("\n".join(partial_lines) + "\n")
    texts = [yaml_path.read_text(), partial_path.read_text()]
    parse_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        raw = [safe_load(t) for t in texts]
        parse_ms.append((time.perf_counter() - t0) * 1e3)
    check(raw[0]["contact"]["contact_name"] == contact,
          f"the folded string read as {raw[0]['contact']['contact_name']!r}")
    from_yaml, from_json = (FastSpeech2Config.from_file(p) for p in (yaml_path, json_path))
    check(from_yaml.training.vocoder_path == str(vocoder_npz.resolve()),
          f"vocoder_path resolved to {from_yaml.training.vocoder_path}")
    a, b = from_yaml.to_dict(), from_json.to_dict()
    a["training"].pop("vocoder_path"), b["training"].pop("vocoder_path")
    check(a == b, "the YAML config differs from phase 11's JSON one")
    log(f"yaml: {yaml_path.name} + {partial_path.name} ({sum(map(len, texts))} bytes) read "
        f"in {statistics.median(parse_ms):.2f} ms (median of 5 parses, {smi}); the config "
        f"equals phase 11's apart from vocoder_path")

    # train from the YAML config through the CLI: 2 steps, a validation at step 2
    overrides = ["training.val_check_interval=2", "training.logger.version=media"]
    log_dir = workdir / "logs" / "smoke" / "media"
    fns = _voc_counters()
    media_calls = []
    media = loop.Trainer._log_validation_media

    def recorded(self, step, batch, out):
        key = "postnet_output" if self.config.model.use_postnet else "output"
        media_calls.append((step, batch, out[key][:1].detach().clone()))
        return media(self, step, batch, out)

    loop.Trainer._log_validation_media = recorded
    try:
        for fn in fns.values():
            fn.launches = 0
        t0 = time.time()
        cli.main(["train", str(yaml_path), "--max-steps", "2"]
                 + [a for o in overrides for a in ("-c", o)])
        train_s = time.time() - t0
        launched = {k: fn.launches for k, fn in fns.items()}
    finally:
        loop.Trainer._log_validation_media = media
    (event_file,) = log_dir.glob("events.out.tfevents.*")
    event_bytes = event_file.stat().st_size
    events = read_events(event_file)
    check(events[0].get("file_version") == "brain.Event:2", f"first event {events[0]}")
    got = scalars(events)
    train_tags = {f"training/{k}_loss" for k in LOSS_KEYS} | {"training/grad_norm"}
    val_tags = {f"validation/{k}_loss" for k in LOSS_KEYS}
    check(set(got) == train_tags | val_tags, f"scalar tags {sorted(got)}")
    check(all([s for s, _ in got[t]] == [1] for t in train_tags)
          and all([s for s, _ in got[t]] == [2] for t in val_tags),
          f"scalar steps {({t: [s for s, _ in v] for t, v in got.items()})}")
    (val_row,) = _rows(log_dir / "val_log.jsonl")
    check(all(got[f"validation/{k}_loss"][0][1] == float(np.float32(val_row[k]))
              for k in LOSS_KEYS), f"validation scalars {got} against {val_row}")
    (step, batch, mel), = media_calls
    name = batch["basename"][0]
    t, l = int(batch["mel_lens"][0]), int(batch["src_lens"][0])
    images = {v["tag"]: (e["step"], decode_png(v["image"]["encoded_image_string"]))
              for e in events for v in e.get("summary", ()) if "image" in v}
    s_att = plotting.scale_for(t, l)
    n_mels, t_pad = batch["mel"].shape[2], batch["mel"].shape[1]
    s_mel = plotting.scale_for(n_mels, t_pad)
    want_images = {f"attention/{name}": (2, (l * s_att, 2 * t * s_att + plotting.GAP, 3)),
                   f"pred/spec_{name}": (2, (2 * n_mels * s_mel + plotting.GAP, t_pad * s_mel, 3))}
    check({k: (st, im.shape) for k, (st, im) in images.items()} == want_images,
          f"images {({k: (st, im.shape) for k, (st, im) in images.items()})}, want {want_images}")
    audio_tags = {v["tag"] for e in events for v in e.get("summary", ()) if "audio" in v}
    check(audio_tags == {f"pred/wav_{name}"}, f"audio tags {audio_tags}")
    vocoder, _, hop = load_vocoder_checkpoint(vocoder_npz, device="cuda")
    diff = {"pred": _check_vocoded(events, f"pred/wav_{name}", mel, vocoder, hop)}
    check(launched["mrf_conv"] == 0, f"the run launched mrf_conv {launched['mrf_conv']} times")
    log(f"yaml train: 2 steps and a validation with media in {train_s:.1f} s; event file "
        f"{event_bytes} bytes, {len(events)} events; {name}: attention "
        f"{images[f'attention/{name}'][1].shape}, spec {images[f'pred/spec_{name}'][1].shape}, "
        f"pred/wav {t_pad * hop} samples within {diff['pred']:.0f} PCM16 steps; launches {launched}")

    # step 0: the preprocessed wav (written for the first validation item) and copy-synthesis
    config = load_config_base_command(yaml_path, overrides)
    trainer = loop.Trainer(config)
    trainer._build_loaders()
    first = next(iter(trainer.val_loader))
    trainer._build_loaders()  # validate's first batch is `first` again
    name0, t0_frames = first["basename"][0], int(first["mel_lens"][0])
    a_cfg = config.preprocessing.audio
    rng = np.random.default_rng(SEED + 28)
    tone = (0.3 * np.sin(2 * np.pi * 180 * np.arange(t0_frames * hop) / a_cfg.input_sampling_rate)
            + 0.01 * rng.standard_normal(t0_frames * hop)).astype(np.float32)
    wav_path = Path(config.preprocessing.save_dir) / "audio" / "--".join(
        [name0, first["speaker"][0], first["language"][0],
         f"audio-{a_cfg.input_sampling_rate}.wav"])
    save_wav(wav_path, tone, a_cfg.input_sampling_rate)
    before = set(log_dir.glob("events.out.tfevents.*"))
    trainer.validate(0, 0)
    trainer.close()
    events0 = [e for path in sorted(log_dir.glob("events.out.tfevents.*"))
               for e in read_events(path) if e["step"] == 0 and "summary" in e]
    gt, _ = _audio_clip(events0, f"gt/wav_{name0}")
    want_gt = np.round(np.clip(load_wav(wav_path, a_cfg.output_sampling_rate), -1, 1) * 32767)
    check(gt.size == tone.size and np.array_equal(gt, want_gt),
          f"gt/wav_{name0}: {gt.size} samples against {tone.size}, "
          f"{np.abs(gt - want_gt).max() if gt.size == want_gt.size else '-'} PCM16 steps off")
    diff["copy_synthesis"] = _check_vocoded(
        events0, f"copy-synthesis/wav_{name0}",
        torch.from_numpy(first["mel"][:1]).cuda(), vocoder, hop)
    log(f"yaml validate(0, 0): gt/wav_{name0} and copy-synthesis/wav_{name0} "
        f"({first['mel'].shape[1] * hop} samples, within {diff['copy_synthesis']:.0f} PCM16 "
        f"steps of the vocoder again); event files {len(before)} -> "
        f"{len(list(log_dir.glob('events.out.tfevents.*')))}")

    # launches and time of a validation with media and one without, in turns
    counters = {k: fns[k] for k in ("attention_fwd", "mas_width1", "ctc_alpha", "mrf_conv")}
    ms = {"media": [], "plain": []}
    counts = {}
    with_media = trainer._log_validation_media
    for i in range(2 * YAML_TIMED):
        kind = ("media", "plain")[(i + i // 2) % 2]  # media, plain, plain, media, media, plain
        trainer._log_validation_media = with_media if kind == "media" else (lambda *a: None)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.validate(3, 0)
        torch.cuda.synchronize()
        ms[kind].append((time.perf_counter() - t0) * 1e3)
        counts.setdefault(kind, {k: fn.launches for k, fn in counters.items()})
    trainer.close()
    check(counts["media"] == counts["plain"] and counts["media"]["mrf_conv"] == 0
          and all(counts["media"][k] > 0 for k in ("attention_fwd", "mas_width1", "ctc_alpha")),
          f"launches with media {counts['media']}, without {counts['plain']}")
    med = {k: statistics.median(v) for k, v in ms.items()}
    crc = crc_rate_mb_s()
    log(f"yaml validation: with media {med['media']:.1f} ms, without {med['plain']:.1f} ms "
        f"(the media {med['media'] - med['plain']:.1f} ms; medians of {YAML_TIMED}, in turns; "
        f"{ms}); launches each {counts['media']}; CRC-32C {crc:.1f} MB/s on the host; "
        f"phase {time.time() - t_phase:.1f} s ({smi})")
    return dict(launches=counts["media"], validation_ms=med, validation_ms_runs=ms,
                media_ms=med["media"] - med["plain"], event_file_bytes=event_bytes,
                crc_mb_s=crc, yaml_parse_ms=statistics.median(parse_ms), train_s=train_s,
                pcm_steps_from_vocoder=diff, phase_s=time.time() - t_phase)


EXPORT_BATCHES = (1, 8)
EXPORT_BUCKETS = (48, 128)  # cut from the default sweep (every 16-multiple to the chunker's max)
EXPORT_TIMED = 10  # request timings a path, in turns
EXPORT_MEL_REL = 1e-3  # rel-L2 of the bf16 model's mels, exported against live (expect 0)
EXPORT_WAV_ABS = 1e-5  # max-abs of the f32 vocoder's wavs and of served mels (expect 0)


def export_texts(rng) -> list:
    """Eight texts of 40-124 characters (a character encodes to one symbol)
    from the serving phase's word list: the eight pad to the 128 bucket and
    the first alone to the 48 bucket, so the live path runs at the exported
    programs' own shapes."""
    texts = []
    for n in (40, 52, 64, 76, 88, 100, 112, 124):
        words = []
        while len(" ".join(words)) < n:
            words.append(str(rng.choice(WORDS)))
        texts.append(" ".join(words)[:n - 1].strip() + ".")
    return texts


def op_inputs():
    """A TorchDispatchMode whose ``captured`` keeps the inputs of the
    ``fs2t::attention_fwd`` call with the largest T a run makes: an exported
    graph calls the op itself, past the module attribute ``KernelInputs``
    patches."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpInputs(TorchDispatchMode):
        captured = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket is torch.ops.fs2t.attention_fwd and (
                    self.captured is None or args[0].shape[2] > self.captured[0].shape[2]):
                self.captured = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                      for a in args)
            return func(*args, **(kwargs or {}))

    return OpInputs()


def _program_calls(ex) -> list:
    """Wrap ``ex._run`` to record (entry, inputs, output) of every program
    call (``del ex._run`` unwraps it); returns the list it appends to."""
    calls, run = [], ex._run

    def recording(entry, *args):
        out = run(entry, *args)
        calls.append((entry, args[1:], out))
        return out

    ex._run = recording
    return calls


def phase_export_serving(workdir: Path, smi: str) -> dict:
    """Phase 27: ``export-serving --platforms cuda`` through the CLI on phase
    11's newest step directory and phase 5's HiFiGAN V1 (6 acoustic, 6
    vocoder and 1 streaming program); the artifact on the card through
    ``ExportedSynthesizer`` (warmup runs all 13), 8 texts at B 8 and one at
    B 1 against the live Synthesizer of the same step directory: durations
    equal, mels within EXPORT_MEL_REL, each vocoder program's wav equal to
    the eager vocoder's on the same input, launches 8 attention_fwd an
    acoustic program call and no other kernel, kernel A against its plain
    version on the inputs the exported program gave it; ``serve model.fs2x``
    answering a wav, a mel and a low_latency request over HTTP; request
    times at B 8 and B 1, exported and live in turns."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, attention_reference
    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import mrf_conv
    from fastspeech2_lightning_tpu_torch.serving import serve
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
    from fastspeech2_lightning_tpu_torch.synthesis.exported import (
        ExportedSynthesizer, default_text_buckets,
    )
    from fastspeech2_lightning_tpu_torch.training.checkpoint import latest_checkpoint

    step_dir = latest_checkpoint(workdir / "logs" / "smoke" / "train" / "checkpoints")
    voc = workdir / "hifigan_v1.npz"  # phase 5's
    art = workdir / "export" / "model.fs2x"
    argv = ["export-serving", str(step_dir), "-o", str(art), "-v", str(voc), "--platforms",
            "cuda", "--streaming-window", str(STREAM_WINDOW)]
    for B in EXPORT_BATCHES:
        argv += ["-b", str(B)]
    for L in EXPORT_BUCKETS:
        argv += ["--text-bucket", str(L)]
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    export_s = time.time() - t0
    line = out.getvalue().strip()
    size_mb = art.stat().st_size / 1e6
    check(line == f"exported serving artifact -> {art} ({size_mb:.1f} MB)",
          f"export-serving printed {line!r}")

    t0 = time.time()
    ex = ExportedSynthesizer(art)
    meta = ex.meta
    counts = {k: len(meta[k]) for k in ("acoustic", "vocoder", "vocoder_streaming")}
    check(ex.device.type == "cuda" and meta["platforms"] == ["cuda"]
          and counts == {"acoustic": 6, "vocoder": 6, "vocoder_streaming": 1},
          f"the artifact: platforms {meta['platforms']}, programs {counts}, on {ex.device}")
    n_warm = ex.warmup(BATCH)
    load_s = time.time() - t0
    check(n_warm == sum(counts.values()), f"warmup ran {n_warm} programs of {counts}")
    sizes = {}
    with zipfile.ZipFile(art) as zf:
        for info in zf.infolist():
            kind = info.filename.split("/")[0] if "/" in info.filename else info.filename
            sizes[kind] = sizes.get(kind, 0) + info.file_size
    default_n = len(default_text_buckets(ex.config, ex.stats))
    log(f"export-serving: {sum(counts.values())} programs ({counts}) for B {EXPORT_BATCHES}, "
        f"text buckets {EXPORT_BUCKETS} (cut from the default sweep of {default_n} buckets), "
        f"window {STREAM_WINDOW}, in {export_s:.1f} s; artifact {size_mb:.1f} MB (uncompressed "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in sorted(sizes.items()))
        + f"); loaded and warmed up (all {n_warm} programs) in {load_s:.1f} s")

    live = Synthesizer.from_checkpoint(step_dir, vocoder_path=voc)
    calls = _program_calls(ex)
    texts = export_texts(np.random.default_rng(SEED + 27))
    buckets = [-(-max(len(ex.text_processor.encode_text(t)) for t in batch) // 16) * 16
               for batch in (texts, texts[:1])]
    check(buckets == list(EXPORT_BUCKETS[::-1]), f"the texts pad to the buckets {buckets}")
    hop = ex.vocoder.hop
    margin = ex.meta["vocoder_meta"]["margin"]
    runs = {}
    torch.backends.cudnn.allow_tf32 = False  # the wavs compare in f32; timed with the default
    for name, batch in (("B8", texts), ("B1", texts[:1])):
        counters = {**_counters(), "mrf_conv": mrf_conv}
        for fn in counters.values():
            fn.launches = 0
        del calls[:]
        with op_inputs() as probe:
            got = ex.synthesize(batch)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        acoustic = [c for c in calls if "L" in c[0]]
        want_launches = {k: 0 for k in counters}
        want_launches["attention_fwd"] = 8 * len(acoustic)
        check(launches == want_launches,
              f"exported {name}: launches {launches}, predicted {want_launches} for "
              f"{len(acoustic)} acoustic program calls")
        want = live.synthesize(batch)
        check(all(np.array_equal(a, b) for a, b in zip(got.durations, want.durations)),
              f"exported {name}: durations differ from the live path's")
        mel_err = max(errors(torch.as_tensor(a), torch.as_tensor(b))
                      for a, b in zip(got.mels, want.mels))
        check(all(a.shape == b.shape for a, b in zip(got.mels, want.mels))
              and mel_err[1] <= EXPORT_MEL_REL,
              f"exported {name}: mel against the live path: max-abs {mel_err[0]}, "
              f"rel-L2 {mel_err[1]}")
        # each vocoder program against the eager vocoder on its own input
        voc_err = 0.0
        for entry, args, wav in calls:
            if "L" not in entry:
                voc_err = max(voc_err, float((wav - live.vocoder.device_fn(args[0])).abs().max()))
        check(voc_err <= EXPORT_WAV_ABS,
              f"exported {name}: a vocoder program differs from the eager vocoder by {voc_err}")
        # the live path trims the vocoder's input at its own bucket: samples
        # whose receptive field ends before it compare
        lens = [m.shape[0] for m in got.mels]
        t_need = -(-max(lens) // 128) * 128
        keep = max(t_need - margin, 0) * hop
        wav_err = max(float(np.abs(a[:keep] - b[:keep]).max(initial=0.0))
                      for a, b in zip(got.wavs, want.wavs))
        check(all(a.shape == b.shape for a, b in zip(got.wavs, want.wavs))
              and wav_err <= EXPORT_WAV_ABS,
              f"exported {name}: wav against the live path: max-abs {wav_err}")
        q, k, v, bias, scale = probe.captured[:5]
        att_err = errors(attention_fwd(q, k, v, bias, scale),
                         attention_reference(q.float(), k.float(), v.float(), bias, scale))
        check(att_err[1] <= 2e-2, f"attention_fwd at the exported program's {list(q.shape)}: "
              f"rel-L2 {att_err[1]}")
        runs[name] = dict(
            programs=[entry.get("file") or entry["files"]["cuda"] for entry, _, _ in calls],
            launches=launches, frames=lens, mel_max_abs=mel_err[0], mel_rel_l2=mel_err[1],
            vocoder_max_abs=voc_err, wav_max_abs=wav_err, attention_shape=list(q.shape),
            attention_max_abs=att_err[0], attention_rel_l2=att_err[1])
        log(f"exported {name}: programs {runs[name]['programs']}; frames {lens}; launches "
            f"{launches}; against the live path: durations equal, mel max-abs {mel_err[0]:.3e} "
            f"(rel-L2 {mel_err[1]:.3e}), wav max-abs {wav_err:.3e} over the samples before "
            f"frame {t_need - margin}; vocoder programs against the eager vocoder max-abs "
            f"{voc_err:.3e}; attention_fwd at {list(q.shape)} against its plain version rel-L2 "
            f"{att_err[1]:.3e}")
    del ex._run
    torch.backends.cudnn.allow_tf32 = True

    # request times, exported and live in turns: one synthesize call (mels,
    # and wavs unless `acoustic`, on the host) between CUDA events
    timings = {}
    for name, batch in (("B8", texts), ("B1", texts[:1])):
        ms = {}
        order = [(path, vocode) for vocode in (True, False) for path in ("exported", "live")]
        for i in range(EXPORT_TIMED):
            for path, vocode in (order if i % 2 == 0 else order[::-1]):
                syn = ex if path == "exported" else live
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                syn.synthesize(batch, vocode=vocode)
                end.record()
                end.synchronize()
                key = path if vocode else f"{path}_acoustic"
                ms.setdefault(key, []).append(start.elapsed_time(end))
        row = timings[name] = {k: statistics.median(v) for k, v in ms.items()}
        log(f"request at {name}: exported {row['exported']:.3f} ms, live {row['live']:.3f} ms "
            f"(ratio {row['exported'] / row['live']:.3f}); without the vocoder exported "
            f"{row['exported_acoustic']:.3f} ms, live {row['live_acoustic']:.3f} ms (ratio "
            f"{row['exported_acoustic'] / row['live_acoustic']:.3f}); medians of "
            f"{EXPORT_TIMED}, in turns ({smi})")
    ex.close()

    server = serve(str(art), port=0, max_batch=BATCH, warmup=True)
    check(server.synthesizer.device.type == "cuda", "serve(model.fs2x) is not on the card")
    server.start()
    try:
        _, health = _get(server.address, "/health")
        wav = _post(server.address, {"text": texts[3]})
        mel = _post(server.address, {"text": texts[3], "format": "mel"})
        low = _stream_post(server.address, {"text": texts[3], "low_latency": True,
                                            "window": STREAM_WINDOW})
    finally:
        server.shutdown()
    frames = np.load(io.BytesIO(mel[1]))
    ref = server.synthesizer.synthesize([texts[3]]).mels[0]
    check(health.get("status") == "ok" and health.get("has_vocoder") is True,
          f"/health {health}")
    check(mel[0] == 200 and frames.shape == ref.shape
          and float(np.abs(frames - ref).max()) <= EXPORT_WAV_ABS,
          f"serving model.fs2x: mel {mel[0]}, {frames.shape} against {ref.shape}")
    for label, (status, body) in (("wav", wav[:2]), ("low_latency", (low[0], low[3]))):
        pcm = np.frombuffer(body[44:], dtype="<i2")
        check(status == 200 and body[:4] == b"RIFF" and pcm.size == ref.shape[0] * hop
              and int(pcm.max()) != int(pcm.min()),
              f"serving model.fs2x: {label} {status}, {pcm.size} samples for "
              f"{ref.shape[0]} frames")
    log(f"serve model.fs2x: wav {wav[2]:.3f} s, mel {mel[2]:.3f} s, low_latency first audio "
        f"{low[1]:.3f} s and whole body {low[2]:.3f} s ({ref.shape[0]} frames)")
    return dict(export_s=export_s, artifact_mb=size_mb, entry_bytes=sizes, programs=counts,
                default_text_buckets=default_n, load_and_warmup_s=load_s, runs=runs,
                request_ms=timings,
                serve=dict(wav_s=wav[2], mel_s=mel[2], low_latency_first_s=low[1],
                           low_latency_s=low[2]))


DIST_STEPS = 4  # each two-rank run's steps (phase 29)
DIST_WARMUP = 30  # Noam rates 3.3e-5 .. 1e-4 over them, 33 to 100 times DIST_ATOL
DIST_RTOL, DIST_ATOL = 1e-5, 1e-6  # tests/test_torch_parallel.py's tolerance
# the losses, grad norms and Adam moments: the card's f32 kernels sum a
# rank's 8 rows in another order than one process's 16 (1.3e-5 of the grad
# norm in one run), so these are held to the port-against-JAX f32 tolerance
# (tests/test_torch_train_step.py); the CPU tests hold them to 1e-5
DIST_MOMENT_RTOL = 1e-4
# the first update, tensor by tensor (the tests' limit), and the share of
# elements left out of it as zero to rounding. The share bounds what the
# update check sees, not what it catches: at step=1/ the elements left out
# follow from the gradients alone, which no fault of the update moves and
# the moment check holds on every element. The card's f32 sums of a rank's
# rows leave out 3.8 % at data=2 (0.04 % between two one-process runs), the
# CPU tests' tiny model 0.1-0.3 %.
DIST_UPDATE_RTOL, DIST_LEFT_OUT = 1e-3, 0.1
# a run may differ from one process by this many times what a second
# one-process run differs from the first (A' sums dQ with atomics)
DIST_SPREAD = 4.0
# the floor under that spread where a run is held by it: relative, far below
# what a wrong gradient moves (a sum taken as a mean halves it)
DIST_FLOOR = 1e-4
DIST_LAUNCHES = {"attention_fwd": 8, "attention_bwd": 8, "mas_width1": 1, "ctc_alpha": 0,
                 "ctc_alpha_beta": 1, "ctc_grad": 1}  # each rank, each step


def _dist_config(workdir: Path, version: str, dtype: str = "float32", **training) -> Path:
    """Phase 11's config (its corpus and buckets, global B 16) with `dtype`,
    its own log directory and `training` overrides; returns its path."""
    cfg = json.loads((workdir / "config.json").read_text())
    cfg["model"]["dtype"] = dtype
    cfg["training"].update(training)
    cfg["training"]["logger"]["version"] = version
    path = workdir / f"config_{version}.json"
    path.write_text(json.dumps(cfg))
    return path


def _skip_update(optimizer) -> None:
    """The planted fault: the optimizer updates its moments and leaves the
    parameters as they were."""
    import torch

    from fastspeech2_lightning_tpu_torch.training.state import AdamWNoam

    optimizer._adam = lambda *a: torch.zeros_like(AdamWNoam._adam(optimizer, *a))


def _dist_fit(config_path: Path, model_parallel: int, steps: int, fault: str = "") -> dict:
    """Trainer.fit on the current card under the current process group (or
    none), the training counters set to 0 before and read after; the rows,
    the launches of training and validation apart, the peak memory and the
    initial weights (on the host)."""
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.training.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(FastSpeech2Config.from_file(config_path), device="cuda:0",
                      model_parallel=model_parallel)
    init = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}
    if fault == "skip_update":
        _skip_update(trainer.optimizer)
    rows = []
    tl, vl = _train_and_validation_launches(lambda: rows.extend(trainer.fit(max_steps=steps)))
    torch.cuda.synchronize()
    return dict(rows=rows, train_launches=tl, validation_launches=vl,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                moments_numel=sum(m.numel() for m in trainer.optimizer.mu), init=init)


def _dist_worker(rank: int, world: int, runs: list, model_parallel: int) -> list:
    """One rank of two-process runs on the one card (gloo): each (config
    path, fault) of `runs` in turn."""
    import gc

    sys.path.insert(0, str(HERE))
    out = []
    for path, fault in runs:
        r = _dist_fit(Path(path), model_parallel, DIST_STEPS, fault)
        r.pop("init")  # the one-process run's is every run's
        out.append(r)
        gc.collect()  # the run's trainer goes before the next one's peak is read
    return out


def _dist_step_dir(config_path: Path, step: int) -> Path:
    cfg = json.loads(config_path.read_text())
    lg = cfg["training"]["logger"]
    return config_path.parent / lg["save_dir"] / lg["name"] / lg["version"] / "checkpoints" / \
        f"step={step}"


def _step_state(step_dir: Path) -> dict:
    """The weights (with the buffers), EMA, Adam moments and update count of
    a step=N/ directory, on the host."""
    import torch

    from fastspeech2_lightning_tpu_torch.training.checkpoint import load_train_state

    out = load_train_state(step_dir)
    out["weights"] = torch.load(step_dir / "model.ckpt", map_location="cpu",
                                weights_only=False)["state_dict"]
    out["ema"] = out["ema"] or {}
    return out


def _max_abs(a: dict, b: dict) -> dict:
    """{part: max |a - b|} over the weights, buffers, EMA and moments."""
    names = set(b["mu"])
    pairs = {"parameters": [k for k in b["weights"] if k in names],
             "buffers": [k for k in b["weights"] if k not in names]}
    out = {}
    for part, keys in pairs.items():
        out[part] = max((float((a["weights"][k].double() - b["weights"][k].double()).abs().max())
                         for k in keys if b["weights"][k].numel()), default=0.0)
    for part in ("ema", "mu", "nu"):
        out[part] = max((float((a[part][k].double() - b[part][k].double()).abs().max())
                         for k in b[part] if b[part][k].numel()), default=0.0)
    return out


def _update_figures(a: dict, b: dict, init: dict) -> dict:
    """The update since `init` of `a` against `b`'s, tensor by tensor over
    the elements whose first moments the two agree on (``settled``), for
    the weights and the EMA: {part: ({name: (rel-L2, left out, elements)},
    keep)}."""
    from fastspeech2_lightning_tpu_torch.parallel.launch import settled, update_errors

    keep = settled([(a["mu"], b["mu"])])
    out = {}
    for part in ("weights", "ema"):
        names = [k for k in b["mu"] if k in b[part]]
        out[part] = (update_errors({k: a[part][k].double() - init[k].double() for k in names},
                                   {k: b[part][k].double() - init[k].double() for k in names},
                                   keep), keep)
    return out


def _f32_problems(got: dict, want: dict, again: dict, init: dict) -> list:
    """What keeps `got` (step=N/ of W ranks, f32) from being `want`'s (one
    process), each limit plus DIST_SPREAD x what `again` (a second one-process
    run) differs from `want` in the same measure:

    - the Adam moments element by element, rtol 1e-4 / atol 1e-6;
    - the update since the initial weights, and the EMA's, tensor by tensor
      within rel-L2 1e-3, and the weights and EMA element by element within
      rtol 1e-5 / atol 1e-6, on the elements whose first moments agree to
      1e-3 relative (``parallel.launch.settled``: Adam turns the sign of a
      gradient that is zero to rounding into a step of the full rate), at
      most 1 % of the elements left out;
    - the buffers, rtol 1e-5 / atol 1e-6, but the running means of the
      BatchNorms that follow a conv bias (such a bias's gradient is zero to
      rounding, and the mean moves with it): twice the rates summed."""
    from fastspeech2_lightning_tpu_torch.training.state import noam_lr

    problems = []
    if got["count"] != want["count"]:
        return [f"update counts {got['count']} and {want['count']}"]

    def check_elements(part, k, d, limit):
        bad = d > limit
        if bool(bad.any()):
            problems.append(f"{part} {k}: {int(bad.sum())} of {d.numel()} elements off by up "
                            f"to {float(d.max()):.3g}")

    for part in ("mu", "nu"):
        for k, w in want[part].items():
            spread = float((again[part][k].double() - w.double()).abs().max())
            check_elements(part, k, (got[part][k].double() - w.double()).abs(),
                           DIST_ATOL + DIST_MOMENT_RTOL * w.double().abs()
                           + DIST_SPREAD * spread)
    figures, own = _update_figures(got, want, init), _update_figures(again, want, init)
    for part in ("weights", "ema"):
        errors, keep = figures[part]
        own_errors, own_keep = own[part]
        left = sum(e[1] for e in errors.values()) / max(sum(e[2] for e in errors.values()), 1)
        if left > DIST_LEFT_OUT:
            problems.append(f"{part}: {left:.3g} of the elements left out as zero to rounding")
        for k, (err, _, _) in errors.items():
            if err > DIST_UPDATE_RTOL + DIST_SPREAD * own_errors[k][0]:
                problems.append(f"{part} {k}: update rel-L2 {err:.3g} (one process against "
                                f"itself {own_errors[k][0]:.3g})")
            w = want[part][k].double()
            spread = (again[part][k].double() - w).abs()[own_keep[k]]
            spread = float(spread.max()) if spread.numel() else 0.0
            d = (got[part][k].double() - w).abs()[keep[k]]
            check_elements(part, k, d, DIST_ATOL + DIST_RTOL * w.abs()[keep[k]]
                           + DIST_SPREAD * spread)
    rates = sum(noam_lr(1e-3, DIST_WARMUP, k) for k in range(want["count"]))
    after_bias = re.compile(r".*(conv_module\.sequential\.3|postnet\.convolutions\.\d\.1)"
                            r"\.running_mean$")
    for k, w in want["weights"].items():
        if k in want["mu"]:
            continue
        w = w.double()
        spread = float((again["weights"][k].double() - w).abs().max()) if w.numel() else 0.0
        check_elements("buffer", k, (got["weights"][k].double() - w).abs(),
                       DIST_ATOL + (2 * rates if after_bias.match(k) else 0.0)
                       + DIST_RTOL * w.abs() + DIST_SPREAD * spread)
    return problems


def _update_summary(got: dict, want: dict, init: dict) -> dict:
    figures = _update_figures(got, want, init)
    out = {}
    for part, (errors, _) in figures.items():
        out[f"{part}_update_rel_l2"] = max(e[0] for e in errors.values())
        out[f"{part}_left_out"] = (sum(e[1] for e in errors.values())
                                   / sum(e[2] for e in errors.values()))
    return out


def _spread_figures(got: dict, want: dict, init: dict, got_norms: list,
                    want_norms: list) -> dict:
    """A run against another: the relative difference of each step's grad
    norm, and, tensor by tensor, the rel-L2 of the first moments and of the
    update since the initial weights (every element)."""
    import numpy as np

    from fastspeech2_lightning_tpu_torch.parallel.launch import update_errors

    names = list(want["mu"])
    every = {k: np.ones(tuple(want["mu"][k].shape), bool) for k in names}
    mu = update_errors(got["mu"], want["mu"], every)
    update = update_errors({k: got["weights"][k].double() - init[k].double() for k in names},
                           {k: want["weights"][k].double() - init[k].double() for k in names},
                           every)
    return {"grad_norm": [abs(g - w) / abs(w) for g, w in zip(got_norms, want_norms)],
            "mu": {k: e[0] for k, e in mu.items()},
            "update": {k: e[0] for k, e in update.items()}}


def _spread_problems(name: str, got: dict, own: dict) -> list:
    """A run's figures (``_spread_figures`` against one process) each within
    DIST_SPREAD times a second one-process run's (`own`) plus DIST_FLOOR. A
    figure of `own` is one sample of the run-to-run noise, so each is
    floored at the median of its family (a predictor's output bias is one
    element): each step's grad norm against own's largest up to that step
    (two runs drift apart as they go), the first moments and the updates
    tensor by tensor. A gradient summed where it should be averaged, or
    left unsummed, moves them by far more."""
    def limit(value, family):
        return DIST_SPREAD * max(value, statistics.median(family)) + DIST_FLOOR

    problems = []
    norms = own["grad_norm"]
    for step, d in enumerate(got["grad_norm"], 1):
        lim = limit(max(norms[:step]), norms)
        if d > lim:
            problems.append(f"{name} step {step} grad norm {d:.3g} relative (limit {lim:.3g})")
    for part in ("mu", "update"):
        family = list(own[part].values())
        for k, err in got[part].items():
            if err > limit(own[part][k], family):
                problems.append(f"{name} {part} {k}: rel-L2 {err:.3g} (one process against "
                                f"itself {own[part][k]:.3g}, median "
                                f"{statistics.median(family):.3g})")
    return problems


def _spread_summary(got: dict, own: dict) -> dict:
    """The figures of a run against ``_spread_problems``' limits, each worst
    one as a share of its limit (1 is the limit)."""
    def share(part):
        med = statistics.median(own[part].values())
        return max(e / (DIST_SPREAD * max(own[part][k], med) + DIST_FLOOR)
                   for k, e in got[part].items())

    return {"grad_norm_rel": got["grad_norm"], "own_grad_norm_rel": own["grad_norm"],
            "mu_share_of_limit": share("mu"), "update_share_of_limit": share("update")}


def _fmt(values: list) -> str:
    return "[" + ", ".join(f"{v:.3g}" for v in values) + "]"


def _cli_train(config: Path, steps: int, world: int = 0) -> subprocess.Popen:
    """`train` through the CLI in a subprocess from the config's folder: one
    process, or `world` ranks of ``train --distributed`` through torchrun
    over NCCL, with PyTorch's defaults (cuDNN on TF32)."""
    from fastspeech2_lightning_tpu_torch.parallel.launch import free_port

    env = {**os.environ, "PYTHONPATH": str(HERE)}
    cmd = [sys.executable, "-m", PORT, "train", str(config), "--max-steps", str(steps)]
    if world:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
               "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
               *cmd[1:], "--distributed"]
    return subprocess.Popen(cmd, env=env, cwd=str(config.parent), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, what: str, steps: int, timeout: float = 900) -> None:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{what} outlived {timeout} s")
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{err[-3000:]}")
    check(out.count(f"trained {steps} steps") == 1, f"{what} printed {out[-2000:]}")


def _initial_weights(config_path: Path) -> dict:
    """The weights a Trainer of this config starts from (the seed's), on
    the host."""
    import torch

    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.training.loop import Trainer

    trainer = Trainer(FastSpeech2Config.from_file(config_path), device="cuda:0")
    init = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    return init


def _f32_reference(workdir: Path) -> dict:
    """Two one-process f32 runs of phase 11's model and corpus, in this
    process, DIST_STEPS steps at Noam rates 3.3e-5 to 1e-4 with a validation
    and a checkpoint after every step (TF32 off): the reference a W-rank f32
    run is held to and the second run's spread from it. Their training
    overrides, rows, initial weights and step=1/ and last step's state."""
    training = dict(val_check_interval=1, async_checkpoint=False,
                    save_top_k_ckpts=DIST_STEPS + 1, ckpt_epochs=0)
    training["optimizer"] = {**json.loads((workdir / "config.json").read_text())["training"]
                             ["optimizer"], "warmup_steps": DIST_WARMUP}
    paths = [_dist_config(workdir, version, **training)
             for version in ("one_f32", "one_f32_again")]
    one, again = (_dist_fit(p, 1, DIST_STEPS) for p in paths)
    init = one.pop("init")
    again.pop("init")
    want, own = ([_step_state(_dist_step_dir(p, s)) for s in (1, DIST_STEPS)] for p in paths)
    norms = [[r["grad_norm"] for r in run["rows"]] for run in (one, again)]
    return dict(training=training, one=one, again=again, init=init, want=want, own=own,
                own_figures=_spread_figures(own[1], want[1], init, norms[1], norms[0]))


def _hold_f32(name: str, config: Path, ranks_rows: list, reference: dict) -> dict:
    """A W-rank f32 run held to the one-process reference (``_f32_reference``)
    at step=1/, where both start from the same weights, so its update must
    be one process's (``_f32_problems``), and by its first step's losses
    and grad norm on each rank (`ranks_rows`, each rank's train rows)
    within rtol 1e-4 / atol 1e-6 plus DIST_SPREAD x the second run's
    distance. After the first step the runs drift apart: Adam's full-rate
    steps on gradients that are zero to rounding, and the alignment
    search's choices, which set the pitch and energy targets, amplify the
    summation order. The last step's figures against one process, and the
    second run's, are reported, not held (finite losses only)."""
    want, own, init = reference["want"], reference["own"], reference["init"]
    got = [_step_state(_dist_step_dir(config, s)) for s in (1, DIST_STEPS)]
    problems = _f32_problems(got[0], want[0], own[0], init)
    one, again = reference["one"]["rows"], reference["again"]["rows"]
    for rank, rows in enumerate(ranks_rows):
        check(len(rows) == DIST_STEPS and all(
            math.isfinite(r[k]) for r in rows for k in LOSS_KEYS + ("grad_norm",) if k in r),
            f"{name} rank {rank}: {rows}")
        for k in [k for k in LOSS_KEYS + ("grad_norm",) if k in one[0]]:
            if not math.isclose(rows[0][k], one[0][k], rel_tol=DIST_MOMENT_RTOL,
                                abs_tol=DIST_ATOL + DIST_SPREAD * abs(again[0][k] - one[0][k])):
                problems.append(f"{name} rank {rank} step 1 {k}: {rows[0][k]} against "
                                f"{one[0][k]}")
    check(not problems, f"{name} against one process: {problems[:8]}")
    figures = _spread_figures(got[1], want[1], init, [r["grad_norm"] for r in ranks_rows[0]],
                              [r["grad_norm"] for r in one])
    return dict(step1=dict(_max_abs(got[0], want[0]), **_update_summary(got[0], want[0], init)),
                last=dict(_spread_summary(figures, reference["own_figures"]),
                          max_abs=_max_abs(got[1], want[1])))


def _bf16_reference(workdir: Path) -> dict:
    """Two one-process runs of phase 11's config (bf16, B 16, 8 steps)
    through the CLI, side by side on the card, in the environment the
    torchrun runs get: the reference a bf16 distributed run is held to, and
    the second one's spread from it (A' sums dQ with atomics, so no two runs
    on the card are equal). Their state, grad norms and initial weights."""
    paths = [_dist_config(workdir, version, dtype="bfloat16")
             for version in ("one_bf16", "one_bf16_again")]
    procs = [_cli_train(p, TRAIN_STEPS) for p in paths]
    for p, proc in zip(paths, procs):
        _finish(proc, f"train {p.name}", TRAIN_STEPS)
    ref, again = (_step_state(_dist_step_dir(p, TRAIN_STEPS)) for p in paths)
    norms = [[r["grad_norm"] for r in _rows(_dist_step_dir(p, TRAIN_STEPS).parents[1]
                                            / "train_log.jsonl")] for p in paths]
    init = _initial_weights(paths[0])
    own = _spread_figures(again, ref, init, norms[1], norms[0])
    return dict(state=ref, norms=norms[0], init=init, own=own)


def _hold_bf16(name: str, config: Path, reference: dict) -> dict:
    """A bf16 distributed run's step=8/ held to the one-process reference
    (``_bf16_reference``, ``_spread_problems``); its figures."""
    step_dir = _dist_step_dir(config, TRAIN_STEPS)
    got = _step_state(step_dir)
    norms = [r["grad_norm"] for r in _rows(step_dir.parents[1] / "train_log.jsonl")]
    figures = _spread_figures(got, reference["state"], reference["init"], norms,
                              reference["norms"])
    problems = _spread_problems(name, figures, reference["own"])
    check(not problems, "; ".join(problems[:8]))
    return dict(_spread_summary(figures, reference["own"]),
                max_abs=_max_abs(got, reference["state"]))


def phase_distributed(workdir: Path, phase11: dict, smi: str) -> dict:
    """Phase 29: data- and tensor-parallel training on the card.

    (i) ``python -m torch.distributed.run --nproc_per_node 1 -m
    fastspeech2_lightning_tpu_torch train --distributed`` over NCCL, phase
    11's config (bf16, B 16) for 8 steps, held to a one-process CLI run of
    the same config in the same environment (``_hold_bf16``: grad norms,
    first moments and updates within 4 x a second one-process run's spread
    from the first, floored at that spread's median, plus 1e-4), its max-abs from phase 11's step=8/ and its
    ms a step beside phase 11's. (ii) two processes on the one card through
    the Python API over gloo (NCCL refuses two ranks on one device): data=2,
    model=2, and data=2 with the ZeRO-1 optimizer, 4 steps each in f32 at
    Noam rates 3.3e-5 to 1e-4 from phase 11's corpus, held to a one-process
    f32 run (``_hold_f32``: step=1/ element by element and by its update,
    step=4/ reported beside a second one-process run's distance),
    the launches on each rank a step, the peak memory with ZeRO-1 and
    without; and a ZeRO-1 run with a planted fault (its parameters left as
    they were) that the step=1/ hold must refuse. (iii) kernels A and A'
    at the dropout offsets the two-rank runs pass them, against their plain
    versions."""
    from fastspeech2_lightning_tpu_torch.parallel.launch import run_local
    from fastspeech2_lightning_tpu_torch.training.state import noam_lr

    out = {"card": smi}
    # (i) torchrun, world 1, NCCL, held to one process in the same environment
    reference = _bf16_reference(workdir)
    cfg_i = _dist_config(workdir, "torchrun", dtype="bfloat16")
    t0 = time.time()
    _finish(_cli_train(cfg_i, TRAIN_STEPS, world=1), "torchrun train --distributed",
            TRAIN_STEPS)
    wall = time.time() - t0
    rows = _rows(_dist_step_dir(cfg_i, TRAIN_STEPS).parents[1] / "train_log.jsonl")
    check([r["step"] for r in rows] == list(range(1, TRAIN_STEPS + 1)), f"rows {rows}")
    held = _hold_bf16("torchrun", cfg_i, reference)
    opt = json.loads(cfg_i.read_text())["training"]["optimizer"]
    b1, b2 = opt["betas"]
    # reported only: an Adam step moves a weight by at most (1 - b1) /
    # sqrt(1 - b2) times the rate, so any two runs stay within twice that
    bound = 2 * (1 - b1) / math.sqrt(1 - b2) * sum(
        noam_lr(opt["learning_rate"], opt["warmup_steps"], k) for k in range(TRAIN_STEPS))
    p11 = _max_abs(_step_state(_dist_step_dir(cfg_i, TRAIN_STEPS)),
                   _step_state(workdir / PHASE11_STEP8))
    loss_rel = max(abs(r["total"] - w) / abs(w) for r, w in zip(rows, phase11["totals"]))
    ms = statistics.median(r["ms"] for r in rows[2:])
    out["torchrun"] = dict(wall_s=wall, ms_per_step=ms, phase11_ms_per_step=phase11["ms"],
                           held=held, phase11_max_abs=p11, phase11_loss_rel=loss_rel,
                           adam_bound=bound)
    log(f"phase 29 (i): torchrun --nproc_per_node 1 train --distributed (NCCL, bf16, B 16): "
        f"{TRAIN_STEPS} steps in {wall:.1f} s wall, median {ms:.1f} ms a step against phase "
        f"11's {phase11['ms']:.1f}; against one process in the same environment: grad norms "
        f"{_fmt(held['grad_norm_rel'])} relative step by step (one process against itself "
        f"{_fmt(held['own_grad_norm_rel'])}), first moments and updates at "
        f"{held['mu_share_of_limit']:.3g} and {held['update_share_of_limit']:.3g} of their "
        f"limits; against phase 11's step=8/: parameters max-abs {p11['parameters']:.3g} "
        f"(Adam's bound {bound:.3g}), mu {p11['mu']:.3g}, losses {loss_rel:.3g} relative "
        f"({smi})")

    # (ii) two ranks on the one card over gloo, f32
    reference = _f32_reference(workdir)
    want, own, init = reference["want"], reference["own"], reference["init"]
    out["one_process_against_itself"] = dict(
        step1=dict(_max_abs(own[0], want[0]), **_update_summary(own[0], want[0], init)),
        last=dict(max_abs=_max_abs(own[1], want[1]), grad_norm_rel=reference["own_figures"]
                  ["grad_norm"]))
    log(f"phase 29 (ii): one f32 process against itself: {out['one_process_against_itself']}")
    results = {}
    for mp, names in ((1, ("data2", "data2_zero1", "data2_zero1_skips_update")),
                      (2, ("model2",))):
        runs_ = [(str(_dist_config(workdir, name, **reference["training"],
                                   fused_optimizer="zero1" in name)),
                  "skip_update" if name.endswith("skips_update") else "") for name in names]
        t0 = time.time()
        ranks = run_local(_dist_worker, 2, runs_, mp, timeout_s=900.0)
        wall = time.time() - t0
        for i, (name, (path, _)) in enumerate(zip(names, runs_)):
            results[name] = (Path(path), [r[i] for r in ranks], wall)
    # the planted fault: moments as they should be, the parameters as they were
    path, _, _ = results.pop("data2_zero1_skips_update")
    faulty = _f32_problems(_step_state(_dist_step_dir(path, 1)), want[0], own[0], init)
    updates = sum("update rel-L2" in p for p in faulty)
    check(updates > 0, f"a ZeRO-1 run that leaves its parameters as they were passed the "
          f"update comparison: {faulty[:4]}")
    out["planted_fault"] = dict(name="data2_zero1_skips_update", findings=len(faulty),
                                updates=updates, first=faulty[:3])
    log(f"phase 29 (ii): a ZeRO-1 run that updates its moments and leaves its parameters as "
        f"they were is refused at step=1/ ({len(faulty)} findings, {updates} of them "
        f"updates; first: {faulty[0]})")
    one = reference["one"]
    runs = {}
    for name in ("data2", "model2", "data2_zero1"):
        path, ranks, wall = results[name]
        held = _hold_f32(name, path, [r["rows"] for r in ranks], reference)
        for rank, r in enumerate(ranks):
            per_step = {k: v / DIST_STEPS for k, v in r["train_launches"].items()}
            check(per_step == DIST_LAUNCHES, f"{name} rank {rank}: launches a step {per_step}, "
                  f"want {DIST_LAUNCHES}")
            check(all(r["validation_launches"][k] > 0 for k in
                      ("attention_fwd", "mas_width1", "ctc_alpha")),
                  f"{name} rank {rank}: validation launches {r['validation_launches']}")
        runs[name] = dict(wall_s=wall, held=held, peak_gib=[r["peak_gib"] for r in ranks],
                          moments_numel=[r["moments_numel"] for r in ranks],
                          ms_per_step=[statistics.median(x["ms"] for x in r["rows"][1:])
                                       for r in ranks],
                          launches=[r["train_launches"] for r in ranks],
                          validation_launches=[r["validation_launches"] for r in ranks])
        s1, last = held["step1"], held["last"]
        log(f"phase 29 (ii) {name} (2 ranks, gloo, f32, B 16): {DIST_STEPS} steps, the "
            f"two-rank call {wall:.1f} s wall; step=1/ against one process: update rel-L2 "
            f"{s1['weights_update_rel_l2']:.3g} ({s1['weights_left_out']:.3g} of the "
            f"elements left out), parameters max-abs {s1['parameters']:.3g}, mu "
            f"{s1['mu']:.3g}; step={DIST_STEPS}/: grad norms {_fmt(last['grad_norm_rel'])} "
            f"relative (one process against itself {_fmt(last['own_grad_norm_rel'])}), "
            f"worst first moments and update at {last['mu_share_of_limit']:.3g} and "
            f"{last['update_share_of_limit']:.3g} of the bf16 hold's limits (reported); peak "
            f"{', '.join(f'{g:.2f}' for g in runs[name]['peak_gib'])} GiB; launches a step "
            f"{DIST_LAUNCHES} on each rank ({smi})")
    n = one["moments_numel"]
    check(runs["data2_zero1"]["moments_numel"] == [-(-n // 2)] * 2,
          f"ZeRO-1 moments {runs['data2_zero1']['moments_numel']} of {n}")
    out.update(one_process=dict(peak_gib=one["peak_gib"], moments_numel=n,
                                ms_per_step=statistics.median(r["ms"] for r in one["rows"][1:])),
               runs=runs, note="two ranks share one card: correctness runs, not a scaling "
               "figure")
    log(f"phase 29 (ii): one process f32 peak {one['peak_gib']:.2f} GiB; data=2 peak "
        f"{max(runs['data2']['peak_gib']):.2f} GiB a rank, with ZeRO-1 "
        f"{max(runs['data2_zero1']['peak_gib']):.2f} ({n} moment elements a tensor in one "
        f"process, {-(-n // 2)} a rank with ZeRO-1) ({smi})")

    # (iii) A and A' at the offsets the ranks pass, against the plain versions
    out["kernels"] = _offset_kernels()
    out["dropout_draw"] = _dropout_draw_ms(smi)
    out["launches"] = {k: sum(x[k] for run in runs.values()
                              for part in ("launches", "validation_launches") for x in run[part])
                       for k in DIST_LAUNCHES}
    return out


def _dropout_draw_ms(smi: str) -> dict:
    """Wall and kernel ms of ``fast_dropout`` on a data rank's [8, 2016,
    1024] bf16 block of the top bucket's FFN activations: drawing the global
    batch's bits (the distributed path) against drawing the block's own
    (one process on 8 rows). The call copies its scale to the card, so its
    device time is the sum of its kernels in a profiler trace
    (``kernels_ms``), not ``device_ms``."""
    import torch

    from fastspeech2_lightning_tpu_torch.models.layers import fast_dropout
    from fastspeech2_lightning_tpu_torch.parallel import ParallelLayout, use_layout

    x = torch.randn(8, 2016, 1024, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"shape": [8, 2016, 1024]}
    for name, lay in (("local", ParallelLayout()),
                      ("global", ParallelLayout(world_size=2, rank=1, data_size=2,
                                                data_rank=1))):
        with use_layout(lay):
            out[f"{name}_draw_ms"] = time_ms(lambda: fast_dropout(x, 0.2, gen))
            out[f"{name}_draw_kernels_ms"] = kernels_ms(lambda: fast_dropout(x, 0.2, gen))
    log(f"phase 29: fast_dropout on a rank's [8, 2016, 1024] bf16 block: wall "
        f"{out['global_draw_ms']:.4f} ms drawing the global batch's bits, "
        f"{out['local_draw_ms']:.4f} drawing its own; kernels {out['global_draw_kernels_ms']} "
        f"and {out['local_draw_kernels_ms']} ({smi})")
    return out


def _offset_kernels() -> list:
    """Kernels A and A' on each rank's inputs of the two-rank runs' top
    bucket, at its dropout offsets, against the plain versions (f32 and
    bf16, p 0.2), and the mask each kernel draws read back bit for bit
    (q = k = 0, one-hot values and output gradients)."""
    import torch

    from fastspeech2_lightning_tpu_torch.ops import attention
    from fastspeech2_lightning_tpu_torch.ops.attention import (
        attention_bwd, attention_dropout_reference, dropout_keep_mask,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    seed = torch.tensor([-2024], dtype=torch.int32, device="cuda")
    rows = []
    # (B, H, row_offset, head_offset): data=2 rank 1 and model=2 rank 1 of a
    # global (16, 2) batch of phase 11's top bucket
    for B, H, r0, h0 in ((8, 2, 8, 0), (16, 1, 0, 1)):
        T, dh = 2016, 128
        bias, _ = _ragged_bias(B, T, g)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(B, H, T, dh, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            o, lse = attention._launch_fwd(q, k, v, bias, dh ** -0.5, 0.2, seed, True, r0, h0, 2)
            grads = attention_bwd(q, k, v, bias, seed, 0.2, dh ** -0.5, o, lse, do, r0, h0, 2)
            torch.cuda.synchronize()
            qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
            want = attention_dropout_reference(qf, kf, vf, bias, seed, 0.2, dh ** -0.5, r0, h0,
                                               2)
            wgrads = torch.autograd.grad(want, (qf, kf, vf), do.float())
            limit = 1e-5 if dtype == torch.float32 else 2e-2
            fwd_abs, fwd_rel = errors(o, want.detach())
            bwd = [errors(a, b) for a, b in zip(grads, wgrads)]
            check(fwd_rel <= limit and all(r <= limit for _, r in bwd),
                  f"A/A' at offsets ({r0}, {h0}, 2) {dtype}: forward rel {fwd_rel:.3g}, "
                  f"backward rel {[r for _, r in bwd]}")
            rows.append(dict(shape=[B, H, T, dh], offsets=[r0, h0, 2], dtype=str(dtype),
                             fwd_max_abs=fwd_abs, fwd_rel=fwd_rel,
                             bwd_max_abs=max(a for a, _ in bwd),
                             bwd_rel=max(r for _, r in bwd)))
            del q, k, v, do, o, lse, grads, qf, kf, vf, want, wgrads
    # the masks, bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        eye = torch.eye(128, device="cuda", dtype=dtype).expand(2, 1, 128, 128).contiguous()
        zero = torch.zeros_like(eye)
        bias = torch.zeros(2, 128, device="cuda")
        o, lse = attention._launch_fwd(zero, zero, eye, bias, 0.1, 0.2, seed, True, 8, 1, 2)
        _, _, dv = attention_bwd(zero, zero, eye, bias, seed, 0.2, 0.1, o, lse, eye, 8, 1, 2)
        whole = dropout_keep_mask(int(seed), 10, 2, 128, 0.2, device="cuda")[8:, 1:]
        check(torch.equal(o != 0, whole) and torch.equal(dv != 0, whole.transpose(-1, -2)),
              f"the {dtype} kernels' masks at offsets (8, 1, 2) are not the global mask's block")
    log(f"phase 29 (iii): A and A' at the ranks' offsets against their plain versions: "
        + "; ".join(f"{r['dtype']} {r['shape']} at {r['offsets']}: forward rel "
                    f"{r['fwd_rel']:.2e}, backward rel {r['bwd_rel']:.2e}" for r in rows)
        + "; both kernels' masks at (8, 1, 2) are the global mask's block, bit for bit")
    return rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    if not (HERE / PORT / "__init__.py").is_file():
        fail(f"{PORT}/ is not beside this script: run it from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import numpy as np

    t_start = time.time()
    smi = phase_device()
    phase_build()
    att = phase_attention()[0]
    mrf_rows = phase_mrf()
    phase_attention_train()
    mas = phase_mas()
    ctc_1024 = phase_ctc()
    cfg = model_config("bfloat16")
    sd = random_state_dict(cfg, np.random.default_rng(SEED))
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_serving(Path(workdir), sd, cfg)
        phase_card_vs_cpu(sd)
        train = phase_train(Path(workdir))
        phase_train_card_vs_cpu(Path(workdir))
        train_att = phase_attention_buckets(Path(workdir))
        ctc_rows = phase_ctc_buckets(Path(workdir), train["shapes"])
        syn = phase_synthesize(Path(workdir))
        phase_synthesize_card_vs_cpu(Path(workdir))
        cond = phase_train_conditioned(Path(workdir), train)
        phase_train_card_vs_cpu(Path(workdir), conditioned=True)
        cond_serve = phase_serve_conditioned(Path(workdir), cond.pop("step_dir"))
        stream = phase_streaming(Path(workdir))
        levels = phase_pfs_phones(Path(workdir))
        voc = phase_vocoder_train(Path(workdir))
        voc["card_vs_cpu"] = phase_vocoder_card_vs_cpu(voc["ckpt_dir"], voc["config_path"])
        vocoder_npz = voc["ckpt_dir"] / "vocoder.npz"
        trained = phase_trained_vocoder(Path(workdir), voc.pop("ckpt_dir"),
                                        voc.pop("config_path"))
        pre = phase_preprocess(Path(workdir))
        checked = phase_check_data(Path(workdir), pre)
        tools = phase_tools(Path(workdir), pre)
        exported = phase_export_serving(Path(workdir), smi)
        yaml_media = phase_yaml_media(Path(workdir), vocoder_npz, smi)
        dist = phase_distributed(Path(workdir), {"totals": train["totals"],
                                                 "ms": train["ms_per_step"]}, smi)
        pre["config_path"], pre["step_dir"] = (str(pre[k].relative_to(workdir))
                                               for k in ("config_path", "step_dir"))
    tl, vl = train["launches"], train["validation_launches"]
    ctl, cvl = cond["launches"], cond["validation_launches"]
    ctc = ctc_rows[-1]  # the top bucket
    sl = {name: sum(syn[run]["launches"].get(name, 0) for run in SYN_RUNS)
          for name in SYN_COUNTERS}

    def by_path(name):
        paths = {"training": tl[name], "validation": vl[name],
                 "conditioned_training": ctl[name], "conditioned_validation": cvl[name]}
        if name in ("attention_fwd", "mas_width1"):
            paths["synthesize"] = sl[name]
        paths["preprocessed_training"] = pre["train_launches"][name]
        paths["preprocessed_validation"] = pre["validation_launches"][name]
        if name in ("attention_fwd", "mas_width1", "ctc_alpha"):
            paths["check-data"] = checked["launches"][name]
            paths["validation_media"] = yaml_media["launches"][name]
        if name in ("attention_fwd", "mas_width1"):
            paths.update({f"benchmark_{mode}": run["launches"][name]
                          for mode, run in tools["benchmark"].items()})
        paths["distributed"] = dist["launches"][name]
        if name == "attention_fwd":
            paths["exported_serving"] = sum(run["launches"][name]
                                            for run in exported["runs"].values())
            paths.update(conditioned_serving=cond_serve["attention_fwd"],
                         streaming=stream["launches"]["attention_fwd"],
                         **{f"{level}_serving": levels[level]["attention_fwd"]
                            for level in LEVELS})
        return paths

    def total(name):
        return sum(by_path(name).values())

    def ctc_entry(name, part, library, library_key, **extra):
        lib = ctc["library"][library_key]
        row = dict(ctc[part], shape=ctc["shape"], dtype="float32", library_ms=lib["ms"])
        return entry(name, row, "ctc_banded_lse.cu", "ops/ctc_pallas.py:120",
                     total(name), launches_by_path=by_path(name), library=library,
                     library_device_ms=lib["device_ms"], device_ms=row["device_ms"],
                     ns_per_frame=row["ns_per_frame"], **extra)

    def entry(name, row, source, replaces, n, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                "dtype")
        return dict(name=name, route="cuda", source=f"{PORT}/csrc/{source}",
                    replaces=f"fastspeech2_lightning_tpu/{replaces}", launches=n,
                    **{k: row[k] for k in keys}, **extra)

    def device_keys(row):
        keys = ("mask", "device_ms", "library_device_ms", "skipped_tile_share")
        return {k: row[k] for k in keys if k in row}

    kernels = [
        entry("attention_fwd", att, "attention_fwd.cu", "models/conformer.py:142",
              launches["attention_fwd"] + total("attention_fwd"),
              launches_by_path={"serving": launches["attention_fwd"],
                                **by_path("attention_fwd")},
              also_replaces=["fastspeech2_lightning_tpu/ops/attention_dropout.py:167",
                             "fastspeech2_lightning_tpu/ops/attention_dropout.py:461"],
              **device_keys(att), training=train_att["fwd"]),
        entry("attention_bwd", train_att["bwd"], "attention_bwd.cu",
              "ops/attention_dropout.py:190", total("attention_bwd"),
              launches_by_path=by_path("attention_bwd"),
              also_replaces=["fastspeech2_lightning_tpu/ops/attention_dropout.py:494"],
              p=train_att["bwd"]["p"], library="SDPA backward alone",
              library_fwd_bwd_ms=train_att["bwd"]["library_fwd_bwd_ms"],
              **device_keys(train_att["bwd"])),
        entry("mas_width1", mas, "mas_width1.cu", "ops/mas_pallas.py:94",
              total("mas_width1"),
              launches_by_path=by_path("mas_width1"),
              device_ms=mas["device_ms"], training_shape=mas["training_shape"]),
        # the training forward (both chains, one launch) and backward, and the
        # validation forward (the alpha chain alone), at the top bucket; all
        # buckets and (16, 1024, 160) ride along
        ctc_entry("ctc_alpha", "fwd", "F.ctc_loss forward", "lib_fwd"),
        ctc_entry("ctc_alpha_beta", "fwd_grad", "F.ctc_loss forward", "lib_fwd",
                  loss_rel=ctc["loss_rel"], buckets=ctc_rows, at_16_1024_160=ctc_1024),
        ctc_entry("ctc_grad", "bwd", "F.ctc_loss forward+backward, against ctc_alpha_beta + "
                  "ctc_grad", "lib_fwd_bwd", grad_max_abs=ctc["grad_max_abs"]),
        # serving's vocoder is f32: that row (C = 128) on top; `stages` holds all six,
        # the bf16 C = 128 row first
        entry("mrf_conv", mrf_rows[1], "mrf_conv.cu", "ops/vocoder_resblocks.py:168",
              launches["mrf_conv"] + stream["launches"]["mrf_conv"] + trained["launches"],
              launches_by_path={"serving": launches["mrf_conv"],
                                "streaming": stream["launches"]["mrf_conv"],
                                "trained_vocoder": trained["launches"]},
              timed=f"one MRF stage: {MRF_LAUNCHES} launches",
              device_ms=mrf_rows[1]["device_ms"], bound_counts=mrf_rows[1]["bound_counts"],
              stages=mrf_rows, stream_window_stages=stream["stages"],
              serving_vocoder=launches["vocoder"]),
    ]
    stream.pop("stages")
    log(f"train: median {train['ms_per_step']:.1f} ms/step, peak {train['peak_gib']:.2f} GiB "
        f"({smi})")
    vt = voc["timing"]
    busy = {d: (v or {}).get("busy_ms", float("nan")) for d, v in vt["device"].items()}
    log(f"vocoder train (B 16, 8192 samples): bf16 {vt['ms_per_step']['bfloat16']:.1f} ms a "
        f"step wall, {busy['bfloat16']:.1f} device busy; f32 "
        f"{vt['ms_per_step']['float32']:.1f} wall, {busy['float32']:.1f} device busy; "
        f"bound {vt['bound_ms']:.2f} ms; peak {vt['peak_gib']:.2f} GiB ({smi})")
    log(f"preprocess ({pre['kept']} utterances, {pre['audio_s']:.1f} s of audio): host "
        f"{pre['host_s']:.1f} s, device {pre['device_s']:.1f} s wall; check-data "
        f"{checked['ms_per_utterance']:.2f} ms a scored utterance ({smi})")
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    log(f"conditioned train: median {cond['ms_per_step']:.1f} ms/step ({cond['ratio_to_plain']:.3f}"
        f" of the unconditioned), peak {cond['peak_gib']:.2f} GiB; stream: first audio "
        f"{stream['first_audio_ms']:.1f} ms against {stream['batched_first_audio_ms']:.1f} batched")
    print(json.dumps({"kernels": kernels, "trainer": train["timing"], "synthesize": syn,
                      "conditioned": {"training": cond, "serving": cond_serve},
                      "streaming": stream, "text_levels": levels,
                      "vocoder_training": {**voc, "trained": trained},
                      "preprocess": pre, "check_data": checked, "tools": tools,
                      "export_serving": exported, "yaml_media": yaml_media,
                      "distributed": dist}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
