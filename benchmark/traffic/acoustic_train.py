"""Acoustic-model training: the ``train`` command's loop, ``Trainer.fit``, on a
seeded preprocessed corpus.

Parameters (the cell's ``params``): ``utterances``, ``chars`` [lo, hi],
``frames_per_char`` [lo, hi], ``max_frames`` (the utterance sizes, the same
in every run), ``training`` (keys of the config's ``training`` section the
cell sets), ``trace_seconds`` and ``limits`` (the checks' limits).

Set-up writes the corpus under the run's temporary directory, builds the
``Trainer`` and gives its model the benchmark's seeded weights, then runs
``fit``. Its first call (the first ``steps_per_call`` steps: an eager step,
the capture, replays) is set-up and the steps the reference follows. The
window opens when that call returns and closes at the first call that
returns ``--seconds`` later; the benchmark marks calls by wrapping the
trainer's per-call method and reads real frames from the batches the loader
yields (``mel_lens`` where ``sample_weight`` is 1). Validation and
checkpoints are set outside the run.

``correct``: the reference, started from the same weights, runs the first
call's steps on the same utterances, collated by itself from the corpus's
files; the program's losses and gradient norms of those steps, its AdamW
first moments (a running mean of the clipped gradients) and its parameters'
change after them are compared leaf by leaf."""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.common import acoustic, corpus, weights
from benchmark.common.compare import leaf_gap, rel_gap
from benchmark.common.harness import Check, Outcome, Readings
from benchmark.common.trace import DeviceTracer, Spans
from benchmark.reference import fastspeech2 as ref
from benchmark.reference.numerics import Numerics, strict_float32

SPEC_NAME = "spec-22050-mel-librosa.npy"
LOSS_CHECKED = ("total", "spec", "postnet", "pitch", "energy", "duration", "attn_ctc")


class WindowClosed(Exception):
    """Raised from the call wrapper to leave ``fit`` once the window closes."""


class RecordingLoader:
    """The trainer's loader, recording each batch it yields."""

    def __init__(self, loader, sink: list):
        self.loader, self.sink = loader, sink

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            w = np.asarray(batch["sample_weight"])
            self.sink.append({"basename": list(batch["basename"]), "weight": w,
                              "src_lens": np.asarray(batch["src_lens"]),
                              "mel_lens": np.asarray(batch["mel_lens"]),
                              "shape": (int(batch["text"].shape[0]), int(batch["text"].shape[1]),
                                        int(batch["mel"].shape[1]))})
            yield batch


def program_config(run, root: Path) -> dict:
    cfg = json.loads(json.dumps({k: run.config[k] for k in
                                 ("model", "preprocessing", "text", "training")}))
    cfg["preprocessing"]["save_dir"] = str(root)
    t = cfg["training"]
    t.update(run.params["training"])
    t.update(seed=run.seed, training_filelist=str(root / "training_filelist.psv"),
             validation_filelist=str(root / "training_filelist.psv"),
             ckpt_epochs=0, ckpt_steps=None, val_check_interval=10 ** 9,
             max_steps=10 ** 9, max_epochs=10 ** 6)
    t["logger"] = {"name": "bench", "save_dir": str(root / "logs"), "version": "run"}
    return cfg


def run(run) -> Outcome:
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.training.loop import Trainer

    p, dev = run.params, run.device
    root = run.workdir / "corpus"
    sizes = corpus.acoustic_sizes(p["utterances"], p["chars"], p["frames_per_char"],
                                  p["max_frames"])
    texts = corpus.write_acoustic_corpus(root, run.seed, sizes,
                                         run.config["preprocessing"]["audio"]["n_mels"],
                                         SPEC_NAME)
    text_of = {f"utt{i:04d}": t for i, t in enumerate(texts)}
    cfg = program_config(run, root)
    trainer = Trainer(FastSpeech2Config.from_dict(cfg), device=dev,
                      log_dir=root / "logs")
    init = weights.make(acoustic.weight_rules(cfg), run.seed, dev)
    named = dict(trainer.model.named_parameters())
    if set(named) != set(init):
        raise RuntimeError(f"the program's parameters differ from the reference's: "
                           f"{sorted(set(named) ^ set(init))[:6]}")
    with torch.no_grad():
        for k, v in init.items():
            named[k].copy_(v)
    del init
    if run.fault == "frozen_step":  # harness test: a step that changes nothing
        trainer.optimizer.lr = 0.0

    batches: list = []
    build = trainer._build_loaders

    def recording_build():
        return RecordingLoader(build(), batches)

    trainer._build_loaders = recording_build
    k = int(p["training"]["steps_per_call"])
    spans = Spans()
    tracer = DeviceTracer(run.trace, p["trace_seconds"], spans)
    calls: list = []  # per timed call: (end time, steps, steps before it, traced)
    state: dict = {}
    inner = trainer._train_call

    def timed_call(n, db, step, epoch):
        if calls:  # the trainer's time between calls: its bookkeeping and the batch wait
            spans.mark("between_calls", calls[-1][0], time.perf_counter())
        if run.fault == "drop_half":  # harness test: half the batch left out
            db = dict(db)
            w = db["sample_weight"].clone()
            w[..., w.shape[-1] // 2:] = 0
            db["sample_weight"] = w
        with spans.span("train_call"):
            rows = inner(n, db, step, epoch)
        t = time.perf_counter()
        if not state:  # the first call: set-up, and the reference's steps
            if run.fault == "alter_loss":  # harness test: an answer altered
                rows[0]["total"] *= 1.01
            state["rows"] = rows
            state["params"] = {name: q.detach().float().cpu().clone() for name, q in named.items()}
            state["mu"] = {name: m.detach().float().cpu().clone() for name, m in
                           zip(trainer.optimizer.names, trainer.optimizer.mu)}
            state["t0"] = time.perf_counter()
            state["setup_s"] = run.setup_s()
            tracer.start()
            return rows
        traced = tracer.prof is not None
        calls.append((t, n, step, traced))
        tracer.poll()
        if t - state["t0"] >= run.seconds:
            raise WindowClosed
        return rows

    trainer._train_call = timed_call
    try:
        trainer.fit()
    except WindowClosed:
        pass
    tracer.stop()
    t_end = calls[-1][0]
    window = t_end - state["t0"]
    first = k  # steps of the first call
    steps = [s for _, n, step, _ in calls for s in range(step, step + n)]
    frames = sum(int(b["mel_lens"][b["weight"] > 0].sum()) for b in (batches[s] for s in steps))
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    log_rows = [json.loads(line) for line in
                (root / "logs" / "train_log.jsonl").read_text().splitlines()]
    log_rows = [r for r in log_rows if first < r["step"] <= first + len(steps)]
    traced_steps = [s for _, n, step, tr in calls if tr for s in range(step, step + n)]
    readings = Readings(
        window_s=window, config=cfg, params=p,
        counters={"steps": len(steps), "calls": len(calls), "frames": frames,
                  "memory_peak_bytes": memory},
        spans=dict(spans.spans),
        records={"log_rows": log_rows,
                 "items": [list(zip(batches[s]["src_lens"][batches[s]["weight"] > 0].tolist(),
                                    batches[s]["mel_lens"][batches[s]["weight"] > 0].tolist()))
                           for s in steps],
                 "traced_batches": [batches[s] for s in traced_steps]},
        trace=tracer.result)
    first_batches = batches[:first]
    program = {"rows": state["rows"], "params": state["params"], "mu": state["mu"]}
    setup_s = state["setup_s"]
    del trainer, named, inner, timed_call, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(run, cfg, root, text_of, first_batches, program, Numerics("float32"))
    return Outcome(attempted=len(steps), failed=0,
                   end_to_end={"train_frames_per_s": frames / window,
                               "setup_s": setup_s},
                   checks=checks, readings=readings, memory_peak_bytes=memory)


def reference_batches(run, cfg, root: Path, text_of: dict, first_batches: list, dev) -> list:
    """The first call's batches collated by the reference from the corpus,
    padded as the loader's one bucket pads: texts to a multiple of 16, mels
    to a multiple of 32 (at most ``max_mel_length``)."""
    sizes = corpus.acoustic_sizes(run.params["utterances"], run.params["chars"],
                                  run.params["frames_per_char"], run.params["max_frames"])
    L = acoustic.round_up(max(c for c, _ in sizes), 16)
    T = min(acoustic.round_up(max(t for _, t in sizes), 32), cfg["model"]["max_mel_length"])
    return [acoustic.collate(root, b["basename"], text_of, b["weight"], L, T, SPEC_NAME, dev)
            for b in first_batches]


def reference_steps(run, cfg, root, text_of, first_batches, num: Numerics) -> dict:
    dev = run.device
    with strict_float32():
        params = weights.make(acoustic.weight_rules(cfg), run.seed, dev)
        start = {k: v.detach().cpu().clone() for k, v in params.items()}
        batches = reference_batches(run, cfg, root, text_of, first_batches, dev)
        out = ref.train_steps(params, acoustic.variance_bins(cfg, dev), cfg, batches,
                              cfg["training"]["seed"], num, first_step=0, epoch=0)
    return {"rows": out["losses"], "start": start,
            "params": {k: v.detach().cpu() for k, v in params.items()},
            "mu": {k: v.detach().cpu() for k, v in out["mu"].items()}}


def check(run, cfg, root, text_of, first_batches, program, num) -> list:
    want = reference_steps(run, cfg, root, text_of, first_batches, num)
    return compare(program, want, run.params["limits"])


def compare(program: dict, want: dict, limits: dict) -> list:
    """The numbers compared, each beside its limit."""
    n = len(want["rows"])
    loss = max(rel_gap(program["rows"][i][k], want["rows"][i][k], want["rows"][i]["total"])
               for i in range(n) for k in LOSS_CHECKED)
    grad_norm = max(rel_gap(program["rows"][i]["grad_norm"], want["rows"][i]["grad_norm"])
                    for i in range(n))
    moved = {k: program["params"][k] - want["start"][k] for k in want["start"]}
    moved_ref = {k: want["params"][k] - want["start"][k] for k in want["start"]}
    mu = leaf_gap(program["mu"], want["mu"], want["mu"])
    change = leaf_gap(moved, moved_ref, want["mu"])
    return [Check("loss_rel_gap", loss, limits["loss_rel_gap"]),
            Check("grad_norm_rel_gap", grad_norm, limits["grad_norm_rel_gap"]),
            Check("adam_mu_leaf_gap", mu, limits["adam_mu_leaf_gap"]),
            Check("param_change_leaf_gap", change, limits["param_change_leaf_gap"])]


def control(run, mode: str) -> list:
    """The checks with the reference computed in `mode` put in the
    program's place, on the corpus's first utterances in batches of the
    cell's size."""
    p = run.params
    root = run.workdir / "corpus"
    sizes = corpus.acoustic_sizes(p["utterances"], p["chars"], p["frames_per_char"],
                                  p["max_frames"])
    texts = corpus.write_acoustic_corpus(root, run.seed, sizes,
                                         run.config["preprocessing"]["audio"]["n_mels"],
                                         SPEC_NAME)
    text_of = {f"utt{i:04d}": t for i, t in enumerate(texts)}
    cfg = program_config(run, root)
    B, k = p["training"]["batch_size"], p["training"]["steps_per_call"]
    first = [{"basename": [f"utt{i * B + j:04d}" for j in range(B)],
              "weight": np.ones(B, np.float32)} for i in range(k)]
    got = reference_steps(run, cfg, root, text_of, first, Numerics(mode))
    want = reference_steps(run, cfg, root, text_of, first, Numerics("float32"))
    return compare(got, want, p["limits"])
