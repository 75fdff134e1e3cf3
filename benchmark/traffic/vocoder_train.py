"""Vocoder training: what the ``train-vocoder`` command's loop
(``training/vocoder.py::train_vocoder``) calls, in its order.

The loop marks no step from outside, so the traffic driver calls its parts: the
state (``create_vocoder_state``, then the benchmark's seeded weights), the
step (``make_vocoder_train_step``), and ``VocoderCropLoader`` on a producer
thread two batches ahead, each batch copied to the card as the loop copies
it, the losses read at step 1 and every ``log_steps`` steps.

Parameters: ``utterances``, ``seconds`` [lo, hi] (the wavs' lengths, the
same in every run), ``training`` (keys of the vocoder training config the
cell sets), ``check_steps`` (the steps the reference follows, run in
set-up), ``trace_seconds`` and ``limits``.

The window opens after the set-up steps and closes at the first step
launched ``--seconds`` later; the card is synchronised at both ends, so
the rate is every step launched in the window over its whole time.

``correct``: the reference runs the set-up steps from the same weights on
crops it cuts itself from the corpus's files with the loader's draws, in
float32 with TF32 off; the first step's losses and every parameter's
change after the last are compared."""

from __future__ import annotations

import dataclasses
import gc
import json
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.common import weights
from benchmark.common.vocoder import discriminator_rules, generator_rules
from benchmark.common.compare import leaf_gap, rel_gap
from benchmark.common.corpus import size_rng
from benchmark.common.harness import Check, Outcome, Readings
from benchmark.common.trace import DeviceTracer, Spans
from benchmark.reference import hifigan as ref
from benchmark.reference.numerics import Numerics, strict_float32

LOSSES = ("d", "g", "g_adv", "fm", "mel_l1")


def wav_sizes(n: int, seconds, sr: int) -> list:
    rng = size_rng("vocoder")
    return [int(rng.uniform(*seconds) * sr) for _ in range(n)]


def write_corpus(root: Path, seed: int, sizes: list, a: dict, device) -> None:
    """Wavs (PCM16) and their log-mels in the preprocessed layout, with a
    filelist: each wav a few seeded partials with vibrato and noise."""
    from scipy.io import wavfile

    sr = a["input_sampling_rate"]
    rng = np.random.default_rng(seed % (1 << 63))
    for kind in ("audio", "spec"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    rows = []
    for i, n in enumerate(sizes):
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 250) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        x = sum(rng.uniform(0.05, 0.2) / k * np.sin(k * phase) for k in range(1, 9))
        x = x + 0.01 * rng.standard_normal(n)
        pcm = np.clip(x, -1, 1 - 1 / 32768)
        name = f"utt{i:04d}--default--default--"
        wavfile.write(root / "audio" / (name + f"audio-{sr}.wav"), sr,
                      (pcm * 32768).astype(np.int16))
        wav = torch.as_tensor((pcm * 32768).astype(np.int16) / 32768.0, dtype=torch.float32,
                              device=device)
        mel = ref.log_mel(wav[None], a, Numerics("float32"))[0]
        np.save(root / "spec" / (name + f"spec-{sr}-{a['spec_type']}.npy"),
                mel.cpu().numpy().astype(np.float32))
        rows.append(f"utt{i:04d}|default|default|a")
    (root / "training_filelist.psv").write_text(
        "\n".join(["basename|speaker|language|characters"] + rows) + "\n")


def reference_crops(root: Path, n_items: int, a: dict, tc: dict, steps: int, device) -> list:
    """The loader's first `steps` batches cut again: its generator seeded
    with the run's seed draws an utterance and a start frame a row."""
    from scipy.io import wavfile

    sr, hop, F = a["input_sampling_rate"], a["fft_hop_size"], tc["frames_per_crop"]
    rng = np.random.default_rng(tc["seed"])
    out = []
    for _ in range(steps):
        mels = np.full((tc["batch_size"], F, a["n_mels"]), np.log(ref.LOG_CLIP), np.float32)
        wavs = np.zeros((tc["batch_size"], F * hop), np.float32)
        for i in range(tc["batch_size"]):
            k = int(rng.integers(n_items))
            name = f"utt{k:04d}--default--default--"
            mel = np.load(root / "spec" / (name + f"spec-{sr}-{a['spec_type']}.npy"))
            wav = wavfile.read(root / "audio" / (name + f"audio-{sr}.wav"))[1] / 32768.0
            T = mel.shape[1]
            s = int(rng.integers(0, T - F)) if T > F else 0
            m, w = mel[:, s:s + F], wav[s * hop:(s + F) * hop]
            mels[i, :m.shape[1]] = m.T
            wavs[i, :len(w)] = w
        out.append({"mel": torch.as_tensor(mels, device=device),
                    "wav": torch.as_tensor(wavs, dtype=torch.float32, device=device)})
    return out


def program_configs(run, root: Path):
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.models.hifigan import HiFiGANConfig
    from fastspeech2_lightning_tpu_torch.models.hifigan_discriminators import (
        DiscriminatorConfig,
    )
    from fastspeech2_lightning_tpu_torch.training.vocoder import VocoderTrainingConfig

    c = {k: run.config[k] for k in ("model", "preprocessing", "text", "training")}
    c = FastSpeech2Config.from_dict(c).to_dict()
    c["preprocessing"]["save_dir"] = str(root)
    c["training"]["training_filelist"] = str(root / "training_filelist.psv")
    tc = dict(run.config["vocoder_training"], **run.params["training"], seed=run.seed)
    v = run.config["vocoder"]
    gen_cfg = HiFiGANConfig(**{k: tuple(tuple(x) if isinstance(x, list) else x for x in val)
                               if isinstance(val, list) else val for k, val in v.items()})
    disc_cfg = DiscriminatorConfig(**{k: tuple(val) if isinstance(val, list) else val
                                      for k, val in run.config["discriminators"].items()})
    return (FastSpeech2Config.from_dict(c), VocoderTrainingConfig(**tc), gen_cfg, disc_cfg, tc)


def _set(module, values: dict) -> None:
    named = dict(module.named_parameters())
    if set(named) != set(values):
        raise RuntimeError(f"the program's parameters differ from the reference's: "
                           f"{sorted(set(named) ^ set(values))[:6]}")
    with torch.no_grad():
        for k, v in values.items():
            named[k].copy_(v)


def _moments(opt, module) -> dict:
    return {k: opt.state[p]["exp_avg"].detach().float().cpu().clone()
            for k, p in module.named_parameters()}


def run(run) -> Outcome:
    from fastspeech2_lightning_tpu_torch.training.vocoder import (
        VocoderCropLoader, create_vocoder_state, make_vocoder_train_step,
    )

    p, dev = run.params, run.device
    a = run.config["preprocessing"]["audio"]
    root = run.workdir / "corpus"
    sizes = wav_sizes(p["utterances"], p["seconds"], a["input_sampling_rate"])
    write_corpus(root, run.seed, sizes, a, dev)
    config, tcfg, gen_cfg, disc_cfg, tc = program_configs(run, root)
    if run.fault == "frozen_step":  # harness test: a step that changes nothing
        tcfg = dataclasses.replace(tcfg, learning_rate=0.0)
    state = create_vocoder_state(gen_cfg, disc_cfg, tcfg, dev)
    G0 = weights.make(generator_rules(run.config["vocoder"]), run.seed, dev)
    D0 = weights.make(discriminator_rules(run.config["discriminators"]), run.seed + 1, dev)
    _set(state.gen, G0)
    _set(state.disc, D0)
    del G0, D0
    step_fn = make_vocoder_train_step(gen_cfg, disc_cfg, tcfg, config.preprocessing.audio)
    loader = VocoderCropLoader(config, tcfg)
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def produce():  # the loop's producer
        batch = None
        while not stop.is_set():
            if batch is None:
                try:
                    batch = loader.next_batch()
                except Exception as e:
                    batch = e
            try:
                q.put(batch, timeout=0.5)
                batch = None
            except queue.Full:
                continue

    producer = threading.Thread(target=produce, name="bench-vocoder-crops", daemon=True)
    producer.start()
    spans = Spans()

    def one_step():
        with spans.span("crop_wait"):
            batch = q.get()
        if isinstance(batch, Exception):
            raise batch
        if run.fault == "drop_half":  # harness test: half the batch left out
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with spans.span("step"):
            losses = step_fn(state, batch)
        step = state.step
        if step % tcfg.log_steps == 0 or step == 1:
            host = {k: float(v) for k, v in losses.items()}
            if not all(np.isfinite(v) for v in host.values()):
                raise RuntimeError(f"non-finite vocoder loss at step {step}: {host}")
        return losses

    try:
        rows, first_m = [], None
        for i in range(p["check_steps"]):
            rows.append({k: float(v) for k, v in one_step().items()})
            if i == 0:
                first_m = {"g": _moments(state.opt_g, state.gen),
                           "d": _moments(state.opt_d, state.disc)}
        if run.fault == "alter_loss":  # harness test: an answer altered
            rows[0]["g"] *= 1.01
        after = {"g": {k: v.detach().cpu().clone() for k, v in state.gen.named_parameters()},
                 "d": {k: v.detach().cpu().clone() for k, v in state.disc.named_parameters()}}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = run.setup_s()
        tracer = DeviceTracer(run.trace, p["trace_seconds"], spans)
        tracer.start()
        t0 = time.perf_counter()
        steps = traced = 0
        while True:
            one_step()
            steps += 1
            if tracer.prof is not None:
                traced += 1
            tracer.poll()
            if time.perf_counter() - t0 >= run.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
        tracer.stop()
    finally:
        stop.set()
        producer.join()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    samples = steps * tcfg.batch_size * tcfg.frames_per_crop * a["fft_hop_size"]
    readings = Readings(window_s=window, config=run.config, params=p,
                        counters={"steps": steps, "traced_steps": traced,
                                  "memory_peak_bytes": memory,
                                  "batch": tcfg.batch_size, "frames": tcfg.frames_per_crop},
                        spans=dict(spans.spans), trace=tracer.result)
    program = {"rows": rows, "first_m": first_m, "after": after}
    del state, step_fn, loader
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(run, root, len(sizes), tc, program, Numerics("float32"))
    return Outcome(attempted=steps, failed=0,
                   end_to_end={"vocoder_train_samples_per_s": samples / window,
                               "setup_s": setup_s},
                   checks=checks, readings=readings, memory_peak_bytes=memory)


def reference(run, root, n_items, tc, num: Numerics) -> dict:
    dev = run.device
    a = run.config["preprocessing"]["audio"]
    with strict_float32():
        G = weights.make(generator_rules(run.config["vocoder"]), run.seed, dev)
        D = weights.make(discriminator_rules(run.config["discriminators"]), run.seed + 1, dev)
        start = {"g": {k: v.cpu().clone() for k, v in G.items()},
                 "d": {k: v.cpu().clone() for k, v in D.items()}}
        batches = reference_crops(root, n_items, a, tc, run.params["check_steps"], dev)
        out = ref.train_steps(G, D, batches, run.config["vocoder"],
                              run.config["discriminators"], a, tc, num)
    return {"rows": out["losses"], "first_m": out["first_m"], "start": start,
            "after": {"g": {k: v.cpu() for k, v in G.items()},
                      "d": {k: v.cpu() for k, v in D.items()}}}


def check(run, root, n_items, tc, program, num) -> list:
    want = reference(run, root, n_items, tc, num)
    return compare(program, want, run.params["limits"])


def compare(program: dict, want: dict, limits: dict) -> list:
    """The numbers compared. Each loss's gap is read at every step, but only
    the first step's is compared: from the second step on, a weight whose
    gradient is nought to rounding has taken Adam's first step of a full
    learning rate in a direction the rounding chose, on either side, and the
    losses of the steps after it swing from seed to seed by that alone. The
    first moments' worst-leaf gap is read but not compared: on some seeds
    the program reads within a factor of two of the bfloat16 control, so no
    limit lies between them. Both go to standard error."""
    by_step = [{k: rel_gap(program["rows"][i][k], want["rows"][i][k]) for k in LOSSES}
               for i in range(len(want["rows"]))]
    print("loss gaps by step: " + json.dumps(by_step), file=sys.stderr)
    mu = max(leaf_gap(program["first_m"][s], want["first_m"][s], want["first_m"][s])
             for s in ("g", "d"))
    print(f"first moments' worst-leaf gap (not compared): {mu!r}", file=sys.stderr)
    change = max(leaf_gap({k: program["after"][s][k] - want["start"][s][k]
                           for k in want["start"][s]},
                          {k: want["after"][s][k] - want["start"][s][k]
                           for k in want["start"][s]},
                          want["first_m"][s]) for s in ("g", "d"))
    return [Check("first_step_loss_gap", max(by_step[0].values()),
                  limits["first_step_loss_gap"]),
            Check("param_change_leaf_gap", change, limits["param_change_leaf_gap"])]


def control(run, mode: str) -> list:
    """The checks with the program's own bfloat16 path put in place of its
    float32 one (``mode`` "program-bfloat16"), or the reference in `mode`
    in the program's place."""
    if mode == "program-bfloat16":
        run.cell.params = dict(run.params, training=dict(run.params["training"],
                                                           compute_dtype="bfloat16"))
        run.seconds = 0.5
        return globals()["run"](run).checks
    a = run.config["preprocessing"]["audio"]
    root = run.workdir / "corpus"
    sizes = wav_sizes(run.params["utterances"], run.params["seconds"], a["input_sampling_rate"])
    write_corpus(root, run.seed, sizes, a, run.device)
    tc = dict(run.config["vocoder_training"], **run.params["training"], seed=run.seed)
    got = reference(run, root, len(sizes), tc, Numerics(mode))
    want = reference(run, root, len(sizes), tc, Numerics("float32"))
    return compare(got, want, run.params["limits"])
