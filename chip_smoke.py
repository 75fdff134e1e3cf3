#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one CUDA card and
check them.

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
    HiFiGAN V1 stages C = 128/64/32 at B = 8 and 256 mel frames;
 5. serving: the default FastSpeech2 config at full width and depth (4+4
    Conformer layers, d = 256, bf16) with seeded random weights and a seeded
    HiFiGAN V1, written as a .ckpt and an .npz and served by ``serve()``;
    8 concurrent /synthesize requests (4 wav, 4 mel), with both kernels'
    launch counts read around this phase;
 6. card against CPU: one f32 batch of the same weights on both;
 7-8. the training attention kernels (forward with dropout, backward)
    against their plain version at (16, 2, 1024 and 2048, 128), bf16 and f32,
    p = 0 and 0.2 with the same seed, on ragged masks with an item that has
    no valid key and one with a hole; the kept share of the mask; times of
    kernel, plain version and F.scaled_dot_product_attention (forward,
    forward+backward, and its backward alone), and in bf16 the device times
    of both kernels and of SDPA;
 9. MAS against its plain version, bit for bit, at B = 16, T 1024/2048,
    L 160/1000;
 10. the CTC alpha and beta-gradient kernels against their plain version at
    B = 16, T = 1024, L = 160, with F.ctc_loss as the yardstick;
 11. training: a seeded 64-utterance corpus, the default config at full width
    and depth in bf16 with batch 16, 8 steps through the ``train`` CLI entry,
    the four training kernels' launch counts read around it, and the final
    checkpoint served one sentence;
 12. card against CPU: one f32 train step (2+2 layers, no dropout) from the
    same weights and batch;
 13. kernels A and A' at each length bucket the trainer cut in phase 11,
    bf16, p = 0 and 0.2, on the bucket's own key mask and on a full one:
    against the plain version; wall and device times beside SDPA's; the
    share of key tiles each skips. The kernels' JSON line takes its
    training rows from the top bucket with its own mask at p = 0.2.

f32 comparisons run with TF32 off. Wall times are medians of CUDA-event
timings of single calls (host time included where the call is shorter than
it); device times are per call of calls queued back to back behind a spin
kernel (``device_ms``). Prints a line for every check and timing, the
kernels' JSON line, the card's name and power limit, and last the result
line.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io
import json
import math
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
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
    fail("device_ms: the card reached the timed calls before the host had queued them")


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


def phase_mrf() -> list:
    import torch

    from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import (
        fused_mrf_stage, mrf_stage_reference, prepare_stage_weights,
    )

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    frames = 256
    for C, T in ((128, frames * 64), (64, frames * 128), (32, frames * 256)):
        blocks = _stage_blocks(C, g)
        x32 = torch.randn(BATCH, T, C, device="cuda", generator=g)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            flat = prepare_stage_weights(blocks, KS, DILS, dtype)
            out = fused_mrf_stage(x, flat, KS, DILS)
            torch.cuda.synchronize()
            ref_blocks = [{n: w.to(dtype).float() for n, w in p.items()} for p in blocks]
            want = mrf_stage_reference(x.float(), ref_blocks, KS, DILS)
            max_abs, rel = errors(out, want)
            limit = 1e-5 if dtype == torch.float32 else 2e-2
            check(rel <= limit, f"mrf stage C={C} {dtype}: rel-L2 {rel} > {limit}")

            dt = str(dtype).split(".")[-1]
            typed_blocks = [{n: w.to(dtype) for n, w in p.items()} for p in blocks]
            kernel = time_ms(lambda: fused_mrf_stage(x, flat, KS, DILS))
            plain = time_ms(lambda: mrf_stage_reference(x, typed_blocks, KS, DILS))
            flops = 2.0 * BATCH * T * C * C * 2 * sum(KS) * len(DILS[0])
            nbytes = (2 * BATCH * T * C + 2 * sum(KS) * len(DILS[0]) * C * C) * x.element_size()
            bound, bound_by = bound_ms(flops, nbytes, dt)
            row = dict(shape=[BATCH, T, C], dtype=dt, launches_per_stage=18,
                       max_abs_err=max_abs, rel_l2=rel, ms=kernel, plain_ms=plain,
                       library_ms=None, bound_ms=bound, bound_by=bound_by)
            log(f"mrf stage [B={BATCH}, T={T}, C={C}] {dt}: max_abs={max_abs:.3e} "
                f"rel_l2={rel:.3e} kernel_ms={kernel:.3f} plain_ms={plain:.3f} "
                f"bound_ms={bound:.3f} ({bound_by})")
            rows.append(row)
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


def phase_serving(workdir: Path, sd: dict, cfg: dict) -> dict:
    """Serve 8 concurrent requests and check them; returns each kernel's
    launch count during the requests."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch.checkpoint import write_checkpoint
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
    log(f"serving: {len(texts)} concurrent requests in {wall:.3f} s (server load + warmup "
        f"{load_s:.1f} s); batches {stats['batches_dispatched']}, batch_ms {stats.get('batch_ms')}; "
        f"launches {launches}")
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
    encoded = encode_texts_for_model(texts, config, tp)
    L = _round_up(max(len(e) for e in encoded), PAD_MULT_TEXT)
    text = np.zeros((len(encoded), L), np.int64)
    for i, e in enumerate(encoded):
        text[i, : len(e)] = e
    lens = np.array([len(e) for e in encoded])
    T = min(config.model.max_mel_length, _round_up(12 * L, 128))
    outs = {}
    for dev in ("cuda", "cpu"):
        model = FastSpeech2(config, n_symbols=len(tp.symbols))
        model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
        model = model.to(dev).eval()
        out = model(torch.as_tensor(text, device=dev), torch.as_tensor(lens, device=dev), T)
        outs[dev] = {k: v.cpu() for k, v in out.items() if v is not None}
    gpu, cpu = outs["cuda"], outs["cpu"]
    check(torch.equal(gpu["duration_rounded"], cpu["duration_rounded"]),
          "duration_rounded differs between card and CPU")
    check(int(cpu["tgt_lens"].min()) > 0, "the f32 batch predicted no frames")
    mel_err = float((gpu["postnet_output"] - cpu["postnet_output"]).abs().max())
    check(mel_err <= 1e-3, f"card vs CPU mel max-abs {mel_err} > 1e-3")
    log(f"card vs CPU (f32, TF32 off): durations equal, frames {cpu['tgt_lens'].tolist()}, "
        f"mel max-abs {mel_err:.3e}")


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
    """[(T, [B] mel lengths)] of each length bucket that the trainer's
    loader cuts from the smoke corpus (phase 11): the decoder attention's
    key masks in training. A bucket of fewer than B utterances is filled
    from its own, as the loader fills it."""
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
    return [(b.max_mel, np.resize(loader.mel_lens[b.indices], tcfg.batch_size))
            for b in loader.buckets]


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
    for T, lens in _bucket_lengths(workdir):
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
    import torch

    from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    row = None
    B = 16
    for T in (1024, 2048):
        for L in (160, 1000):
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
            kernel = time_ms(lambda: mas_width1(la, in_lens, out_lens), iters=10)
            plain = time_ms(lambda: mas_width1_reference(la, in_lens, out_lens), warmup=1,
                            iters=2)
            bound = bound_ms(0.0, 2 * B * T * L * 4 + B * L * 4, "float32")
            log(f"mas_width1 B={B} T={T} L={L}: bit-exact, kernel_ms={kernel:.4f} "
                f"plain_ms={plain:.2f} bound_ms={bound[0]:.4f} ({bound[1]})")
            if (T, L) == (2048, 1000):
                row = dict(shape=[B, T, L], dtype="float32", max_abs_err=0.0, ms=kernel,
                           plain_ms=plain, library_ms=None, bound_ms=bound[0],
                           bound_by=bound[1])
    return row


# -- phase 10: CTC (kernel C) ------------------------------------------------


def phase_ctc() -> dict:
    import torch
    import torch.nn.functional as F

    from fastspeech2_lightning_tpu_torch.ops import ctc

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    B, T, L = 16, 1024, 160
    S = 2 * L + 1
    in_lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
    out_lens = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g)
    in_lens[0], out_lens[0] = L, T
    attn = torch.randn(B, T, L, device="cuda", generator=g)
    logits = torch.cat([torch.full((B, T, 1), -1.0, device="cuda"), attn], -1)
    logits = torch.where(torch.arange(L + 1, device="cuda") > in_lens[:, None, None],
                         ctc.NEG_INF, logits)
    lp = torch.log_softmax(logits, -1)
    gvec = torch.rand(B, device="cuda", generator=g)

    alphas = ctc.ctc_alpha(lp, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    grad = ctc.ctc_beta_grad(lp, alphas, in_lens, out_lens, ll, gvec)
    torch.cuda.synchronize()
    want_alphas = ctc.ctc_alpha_reference(lp, out_lens)
    want_ll = ctc._final_ll(want_alphas[:, -1], in_lens)
    want_grad = ctc.ctc_beta_grad_reference(lp, want_alphas, in_lens, out_lens, want_ll, gvec)
    loss_rel = float(((ll - want_ll).abs() / want_ll.abs()).max())
    grad_abs = float((grad - want_grad).abs().max())
    check(loss_rel <= 1e-5, f"ctc loss rel {loss_rel} > 1e-5")
    check(grad_abs <= 1e-5, f"ctc grad_y max-abs {grad_abs} > 1e-5")

    targets = torch.arange(1, L + 1, device="cuda").expand(B, L)
    lp_tbc = lp.transpose(0, 1).contiguous()

    def lib_forward():
        return F.ctc_loss(lp_tbc, targets, out_lens, in_lens, blank=0, reduction="none",
                          zero_infinity=True)

    lib_rel = float(((lib_forward() - (-ll)).abs() / ll.abs()).max())
    lp_g = lp_tbc.clone().requires_grad_(True)

    def lib_fwd_bwd():
        loss = F.ctc_loss(lp_g, targets, out_lens, in_lens, blank=0, reduction="none",
                          zero_infinity=True)
        torch.autograd.grad(loss, lp_g, gvec)

    a_ms = time_ms(lambda: ctc.ctc_alpha(lp, out_lens), iters=10)
    b_ms = time_ms(lambda: ctc.ctc_beta_grad(lp, alphas, in_lens, out_lens, ll, gvec), iters=10)
    a_plain = time_ms(lambda: ctc.ctc_alpha_reference(lp, out_lens), warmup=1, iters=3)
    b_plain = time_ms(lambda: ctc.ctc_beta_grad_reference(lp, alphas, in_lens, out_lens, ll,
                                                          gvec), warmup=1, iters=3)
    a_lib = time_ms(lib_forward, iters=10)
    b_lib = time_ms(lib_fwd_bwd, iters=10)
    a_bound = bound_ms(0.0, B * T * ((L + 1) + S) * 4, "float32")
    b_bound = bound_ms(0.0, B * T * (2 * (L + 1) + S) * 4, "float32")
    log(f"ctc B={B} T={T} L={L}: loss rel={loss_rel:.3e} grad_y max_abs={grad_abs:.3e} "
        f"(F.ctc_loss against ours: rel {lib_rel:.3e})")
    log(f"ctc_alpha: kernel_ms={a_ms:.4f} plain_ms={a_plain:.3f} library_ms={a_lib:.4f} "
        f"(F.ctc_loss forward) bound_ms={a_bound[0]:.4f} ({a_bound[1]})")
    log(f"ctc_beta_grad: kernel_ms={b_ms:.4f} plain_ms={b_plain:.3f} library_ms={b_lib:.4f} "
        f"(F.ctc_loss forward+backward) bound_ms={b_bound[0]:.4f} ({b_bound[1]})")
    common = dict(shape=[B, T, L], dtype="float32")
    return {
        "alpha": dict(common, max_abs_err=float((ll - want_ll).abs().max()), loss_rel=loss_rel,
                      ms=a_ms, plain_ms=a_plain, library_ms=a_lib, bound_ms=a_bound[0],
                      bound_by=a_bound[1]),
        "beta": dict(common, max_abs_err=grad_abs, ms=b_ms, plain_ms=b_plain, library_ms=b_lib,
                     bound_ms=b_bound[0], bound_by=b_bound[1]),
    }


# -- phase 11: training through the CLI --------------------------------------

N_UTTS = 64


def write_corpus(root: Path, cfg: dict, rng) -> None:
    """A seeded preprocessed corpus in the layout the dataset reads: per
    utterance a mel spec [n_mels, T], frame-level pitch and energy, a
    diagonal attention prior [T, L]; stats.json and the filelists. Texts of
    20-200 characters, mels of 100-2000 frames (one of exactly 2000, so a
    bucket pads above 1536 frames)."""
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
    for i in range(N_UTTS):
        n_chars = int(rng.integers(20, 201))
        words = []
        while len(" ".join(words)) < n_chars:
            words.append(str(rng.choice(WORDS)))
        text = " ".join(words)[:n_chars].strip()
        L = len(tp.encode_text(text))
        T = 2000 if i == 0 else int(np.clip(L * rng.uniform(6, 10), 100, 2000))
        name = f"utt{i:03d}--default--default--"
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
        rows.append(f"utt{i:03d}|default|default|{text}")
    header = "basename|speaker|language|characters"
    (root / "training_filelist.psv").write_text("\n".join([header] + rows) + "\n")
    (root / "validation_filelist.psv").write_text("\n".join([header] + rows[:2]) + "\n")
    (root / "stats.json").write_text(json.dumps(STATS))


TRAIN_STEPS = 8


def phase_train(workdir: Path) -> dict:
    """Train the default config (full width and depth, bf16, batch 16) for
    8 steps through the port's CLI entry; returns the launches, ms/step and
    peak memory, after serving one sentence from the final checkpoint."""
    import numpy as np
    import torch

    from fastspeech2_lightning_tpu_torch import cli
    from fastspeech2_lightning_tpu_torch.ops.attention import attention_bwd, attention_fwd
    from fastspeech2_lightning_tpu_torch.ops.ctc import ctc_alpha, ctc_beta_grad
    from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1
    from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer

    cfg = model_config("bfloat16")
    corpus = workdir / "corpus"
    t0 = time.time()
    write_corpus(corpus, cfg, np.random.default_rng(SEED + 7))
    cfg["preprocessing"]["save_dir"] = "corpus"
    cfg["training"].update(batch_size=16, training_filelist="corpus/training_filelist.psv",
                           validation_filelist="corpus/validation_filelist.psv")
    cfg["training"]["logger"].update(save_dir="logs", name="smoke", version="train")
    config_path = workdir / "config.json"
    config_path.write_text(json.dumps(cfg))
    log(f"train: corpus of {N_UTTS} utterances written in {time.time() - t0:.1f} s")

    counters = (attention_fwd, attention_bwd, mas_width1, ctc_alpha, ctc_beta_grad)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cli.main(["train", str(config_path), "--max-steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    log_dir = workdir / "logs" / "smoke" / "train"
    rows = [json.loads(line) for line in (log_dir / "train_log.jsonl").read_text().splitlines()]
    check(len(rows) == TRAIN_STEPS, f"{len(rows)} steps logged, want {TRAIN_STEPS}")
    loss_keys = ("total", "spec", "postnet", "pitch", "energy", "duration", "attn_ctc",
                 "attn_bin", "grad_norm")
    for r in rows:
        check(all(k in r and math.isfinite(r[k]) for k in loss_keys), f"step {r['step']}: {r}")
        log(f"train step {r['step']}: B x L x T = {' x '.join(map(str, r['shape']))}, "
            f"{r['ms']:.1f} ms, total {r['total']:.4f}, attn_ctc {r['attn_ctc']:.4f}, "
            f"grad_norm {r['grad_norm']:.3f}")
    check(max(r["shape"][2] for r in rows) > 1536, "no bucket above 1536 frames was trained")
    want = {"attention_fwd": 8 * TRAIN_STEPS, "attention_bwd": 8 * TRAIN_STEPS,
            "mas_width1": TRAIN_STEPS, "ctc_alpha": TRAIN_STEPS, "ctc_beta_grad": TRAIN_STEPS}
    check(launches == want, f"training launches {launches}, predicted {want}")
    ms_step = statistics.median(r["ms"] for r in rows[2:])

    syn = Synthesizer.from_checkpoint(log_dir / "checkpoints" / "last.ckpt")
    check(syn.device.type == "cuda", f"the trained checkpoint loaded on {syn.device}")
    mel = syn.synthesize(["the trained model speaks."]).mels[0]
    check(mel.ndim == 2 and mel.shape[1] == 80 and bool(np.isfinite(mel).all()),
          f"synthesis from the trained checkpoint gave {mel.shape}")
    log(f"train: {TRAIN_STEPS} steps in {wall:.1f} s (model build, loader and first-step "
        f"set-up included); median step after step 2 {ms_step:.1f} ms; peak memory "
        f"{peak_gib:.2f} GiB; launches {launches}; last.ckpt synthesized {mel.shape[0]} frames")
    return dict(launches=launches, ms_per_step=ms_step, peak_gib=peak_gib,
                shapes=[r["shape"] for r in rows])


# -- phase 12: card against CPU, one train step ------------------------------


def phase_train_card_vs_cpu(workdir: Path) -> None:
    """One f32 train step (2+2 layers, full width, every dropout 0, no
    PostNet) from the same weights and batch on the card and on the CPU."""
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
        batch_to_device, step_generator, train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config("float32")
    for part in ("encoder", "decoder"):
        cfg["model"][part].update(layers=2, dropout=0.0)
    for kind in ("pitch", "energy", "duration"):
        cfg["model"]["variance_predictors"][kind]["dropout"] = 0.0
    cfg["model"]["use_postnet"] = False
    cfg["preprocessing"]["save_dir"] = str(workdir / "corpus")
    config = FastSpeech2Config.from_dict(cfg)
    items = load_filelist(workdir / "corpus" / "training_filelist.psv")
    ds = FastSpeechDataset(items, config, {"default": 0}, {"default": 0})
    samples = sorted((ds[i] for i in range(8)), key=lambda s: s["mel"].shape[0])[:4]
    batch = collate(samples, _round_up(max(len(s["text"]) for s in samples), PAD_MULT_TEXT),
                    _round_up(max(s["mel"].shape[0] for s in samples), PAD_MULT_MEL))
    batch["sample_weight"] = np.array([1, 1, 1, 0], np.float32)

    model = FastSpeech2(config, n_symbols=len(TextProcessor(config.text).symbols))
    init_like_flax(model, SEED)
    with torch.no_grad():
        for kind in ("pitch", "energy"):
            st = STATS[kind]
            getattr(model.variance_adaptor, f"{kind}_bins").copy_(
                torch.linspace(st["norm_min"], st["norm_max"], 255))
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
    log(f"card vs CPU train step (f32, TF32 off, 2+2 layers, B=4, T={batch['mel'].shape[1]}): "
        f"durations equal, worst loss rel {worst_loss:.3e}, worst parameter max-abs "
        f"{worst_param:.3e}")


# -- main --------------------------------------------------------------------


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
    mrf = phase_mrf()[0]
    phase_attention_train()
    mas = phase_mas()
    ctc = phase_ctc()
    cfg = model_config("bfloat16")
    sd = random_state_dict(cfg, np.random.default_rng(SEED))
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_serving(Path(workdir), sd, cfg)
        phase_card_vs_cpu(sd)
        train = phase_train(Path(workdir))
        phase_train_card_vs_cpu(Path(workdir))
        train_att = phase_attention_buckets(Path(workdir))
    tl = train["launches"]

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
              launches["attention_fwd"] + tl["attention_fwd"],
              launches_by_path={"serving": launches["attention_fwd"],
                                "training": tl["attention_fwd"]},
              also_replaces=["fastspeech2_lightning_tpu/ops/attention_dropout.py:167",
                             "fastspeech2_lightning_tpu/ops/attention_dropout.py:461"],
              **device_keys(att), training=train_att["fwd"]),
        entry("attention_bwd", train_att["bwd"], "attention_bwd.cu",
              "ops/attention_dropout.py:190", tl["attention_bwd"],
              also_replaces=["fastspeech2_lightning_tpu/ops/attention_dropout.py:494"],
              p=train_att["bwd"]["p"], library="SDPA backward alone",
              library_fwd_bwd_ms=train_att["bwd"]["library_fwd_bwd_ms"],
              **device_keys(train_att["bwd"])),
        entry("mas_width1", mas, "mas_width1.cu", "ops/mas_pallas.py:94", tl["mas_width1"]),
        entry("ctc_alpha", ctc["alpha"], "ctc_banded_lse.cu", "ops/ctc_pallas.py:120",
              tl["ctc_alpha"], library="F.ctc_loss forward"),
        entry("ctc_beta_grad", ctc["beta"], "ctc_banded_lse.cu", "ops/ctc_pallas.py:120",
              tl["ctc_beta_grad"], library="F.ctc_loss forward+backward"),
        entry("mrf_conv", mrf, "mrf_conv.cu", "ops/vocoder_resblocks.py:168",
              launches["mrf_conv"], timed="one MRF stage: 18 launches"),
    ]
    log(f"train: median {train['ms_per_step']:.1f} ms/step, peak {train['peak_gib']:.2f} GiB "
        f"({smi})")
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
