#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Drives ``fastspeech2_lightning_tpu_torch`` (never the JAX package) through
its own entry points and fails, exiting non-zero, if any phase fails:

 1. device: the card's name and power limit, as nvidia-smi reports them;
 2. build: one nvcc per ``csrc/*.cu`` for sm_90a, all started together;
 3. attention_fwd against its plain version at the decoder's serving shape
    and two others, with a ragged key mask; times of the kernel, the plain
    version and F.scaled_dot_product_attention (a yardstick only);
 4. the MRF stage (18 mrf_conv launches) against its plain version for the
    HiFiGAN V1 stages C = 128/64/32 at B = 8 and 256 mel frames;
 5. serving: the default FastSpeech2 config at full width and depth (4+4
    Conformer layers, d = 256, bf16) with seeded random weights and a seeded
    HiFiGAN V1, written as a .ckpt and an .npz and served by ``serve()``;
    8 concurrent /synthesize requests (4 wav, 4 mel), with both kernels'
    launch counts read around this phase;
 6. card against CPU: one f32 batch of the same weights on both.

f32 comparisons run with TF32 off. Prints a line for every check and
timing, the kernels' JSON line, the card's name and power limit, and last the
result line.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io
import json
import math
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
    check(names == ["attention_fwd", "mrf_conv"], f"unexpected kernel sources {names}")
    logs = build.build(names)
    seconds = time.time() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
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
    for (B, H, T, dh), dtype in (((8, 2, 1024, 128), torch.bfloat16),
                                 ((8, 2, 1000, 128), torch.float32),
                                 ((8, 4, 160, 64), torch.float32)):
        q, k, v = (torch.randn(B, H, T, dh, device="cuda", generator=g).to(dtype)
                   for _ in range(3))
        lens = torch.linspace(T, T // 3, B, device="cuda").round().long()
        lens[1] = T - 37  # ragged, off any tile boundary
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
        kernel = time_ms(lambda: attention_fwd(q, k, v, bias, scale))
        plain = time_ms(lambda: attention_reference(q, k, v, bias, scale))
        library = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                 scale=scale))
        dt = str(dtype).split(".")[-1]
        flops = 4.0 * H * T * dh * float(lens.sum())  # keys the mask keeps
        nbytes = 4 * B * H * T * dh * q.element_size() + B * T * 4
        bound, bound_by = bound_ms(flops, nbytes, dt)
        row = dict(shape=[B, H, T, dh], dtype=dt, max_abs_err=max_abs, rel_l2=rel,
                   ms=kernel, plain_ms=plain, library_ms=library, bound_ms=bound,
                   bound_by=bound_by)
        log(f"attention_fwd {B, H, T, dh} {dt}: max_abs={max_abs:.3e} rel_l2={rel:.3e} "
            f"kernel_ms={kernel:.4f} plain_ms={plain:.4f} library_ms={library:.4f} "
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
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.synthesis.prepare import (
        PAD_MULT_TEXT, _round_up, encode_texts_for_model,
    )
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
    cfg = model_config("bfloat16")
    sd = random_state_dict(cfg, np.random.default_rng(SEED))
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_serving(Path(workdir), sd, cfg)
    phase_card_vs_cpu(sd)

    kernels = [
        dict(name="attention_fwd", route="cuda",
             source=f"{PORT}/csrc/attention_fwd.cu",
             replaces="fastspeech2_lightning_tpu/models/conformer.py:142",
             launches=launches["attention_fwd"], max_abs_err=att["max_abs_err"],
             ms=att["ms"], plain_ms=att["plain_ms"], bound_ms=att["bound_ms"],
             bound_by=att["bound_by"], library_ms=att["library_ms"],
             shape=att["shape"], dtype=att["dtype"]),
        dict(name="mrf_conv", route="cuda", source=f"{PORT}/csrc/mrf_conv.cu",
             replaces="fastspeech2_lightning_tpu/ops/vocoder_resblocks.py:168",
             launches=launches["mrf_conv"], max_abs_err=mrf["max_abs_err"],
             ms=mrf["ms"], plain_ms=mrf["plain_ms"], bound_ms=mrf["bound_ms"],
             bound_by=mrf["bound_by"], library_ms=None, shape=mrf["shape"],
             dtype=mrf["dtype"], timed="one MRF stage: 18 launches"),
    ]
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
