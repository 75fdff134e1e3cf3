"""Timing and FLOP counting for the ``benchmark`` command (counterpart of the
JAX package's ``utils/benchmarking.py``).

The discipline is the JAX package's:

* the timed call threads a scalar ``carry`` through every call: the carry is
  added to a real input and re-derived from the output, so call i+1 depends
  on call i (``chainable``);
* a trial is ``reps`` calls between two CUDA events with one synchronize at
  its end, which also reads the carry back and checks that it is finite
  (``time_chained``; ``time_pipelined`` issues independent calls and sums
  their scalars instead);
* FLOPs per call come from ``torch.utils.flop_counter`` (``count_flops``),
  and the implied MFU against the card's peak must not exceed 100 %
  (``check_mfu``): above it the timing is broken, not fast.

``FlopCounterMode`` sees PyTorch operators, and ``torch.library`` ops with a
FLOP formula: kernel A is the op ``fs2t::attention_fwd``, counted once a call
at its plain version's products on either device. A kernel launched by
ctypes is invisible to it: the wrapper of A′ adds its plain version's
products to ``attention_bwd.flops`` where it launches, and ``count_flops``
adds that counter's change, so a call counts the same on the card and on the
CPU. The other kernels' plain versions multiply no matrices (MAS, CTC) and
count 0; the MRF stage's convolutions are not counted on the card (no path
timed here runs it).

``prepare_benchmark`` builds what the command times: the first batch of
``BucketedLoader(train, batch_size, seed=0)`` and a model with the flax
initial distributions (seed 0) and the corpus's variance bins, and the
forward of the chosen mode."""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

# NVIDIA H100 SXM dense bf16 tensor-core peak: the MFU denominator, one for
# every dtype as the JAX package has one (its TPU v5e peak)
H100_PEAK_FLOPS = 989e12
BENCHMARK_TYPES = ("training", "inference")


def chainable(apply_fn: Callable[[dict], torch.Tensor], carry_key: str):
    """Wrap ``apply_fn(batch) -> tensor`` into ``fn(batch, carry) -> (out,
    new_carry)`` with a data dependency through ``batch[carry_key]`` (a
    float tensor): the carry is added to it, and the next carry is 1e-12 of
    the sum of the output's first four entries."""

    def fn(batch: dict, carry: torch.Tensor):
        batch = dict(batch)
        batch[carry_key] = batch[carry_key] + carry
        out = apply_fn(batch)
        return out, out.reshape(-1)[:4].float().sum() * 1e-12

    return fn


def count_flops(fn: Callable, *args) -> int:
    """FLOPs of one call ``fn(*args)``: FlopCounterMode's total plus what
    A′'s wrapper counted for its launches during the call."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.attention import attention_bwd

    before = attention_bwd.flops
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops()) + attention_bwd.flops - before


class _Clock:
    """Seconds between ``start`` and ``stop``: CUDA events on the card (the
    device's clock; ``stop`` synchronizes on its event), the host's clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self._t0.elapsed_time(t1) / 1e3
        return time.perf_counter() - self._t0


def _device(batches: List[dict]) -> torch.device:
    return next(v.device for v in batches[0].values() if isinstance(v, torch.Tensor))


def time_chained(fn, staged_batches: List[dict], *, reps: int, trials: int = 5,
                 warmup: int = 5) -> List[float]:
    """Seconds of each of `trials` chains of `reps` calls (``chainable``'s
    signature) over the staged device batches, after `warmup` calls; each
    trial ends with one synchronize and a check that the carry is finite."""
    device = _device(staged_batches)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    n = len(staged_batches)
    carry = zero
    for i in range(warmup):
        _, carry = fn(staged_batches[i % n], carry)
    float(carry)  # the warmup has finished
    clock = _Clock(device)
    times = []
    for _ in range(trials):
        carry = zero
        clock.start()
        for i in range(reps):
            _, carry = fn(staged_batches[i % n], carry)
        times.append(clock.stop())
        final = float(carry)
        assert math.isfinite(final), "non-finite output in timed chain"
    return times


def time_pipelined(fn_scalar, staged_batches: List[dict], *, reps: int, trials: int = 5,
                   warmup: int = 5) -> List[float]:
    """Throughput timing: `reps` independent calls ``fn_scalar(batch) ->
    0-d tensor`` (no data dependency between them), then one synchronize and
    a read of the sum of their scalars; seconds a trial."""
    device = _device(staged_batches)
    n = len(staged_batches)
    float(sum(fn_scalar(staged_batches[i % n]) for i in range(warmup)))
    clock = _Clock(device)
    times = []
    for _ in range(trials):
        clock.start()
        outs = [fn_scalar(staged_batches[i % n]) for i in range(reps)]
        total = torch.stack(outs).sum()
        times.append(clock.stop())
        assert math.isfinite(float(total)), "non-finite output in timed pipeline"
    return times


def check_mfu(flops_per_call: float, sec_per_call: float) -> float:
    """The implied MFU against ``H100_PEAK_FLOPS``; raises above 100 %
    (impossible, so the timing is broken)."""
    if flops_per_call <= 0 or sec_per_call <= 0:
        return 0.0
    mfu = flops_per_call / sec_per_call / H100_PEAK_FLOPS
    if mfu > 1.0:
        raise SystemExit(
            f"BENCH INVALID: implied MFU {mfu * 100:.1f}% > 100% "
            f"({flops_per_call / 1e12:.2f} TFLOP/call at "
            f"{sec_per_call * 1e3:.3f} ms/call) — timing did not force real "
            "execution; refusing to report fiction."
        )
    return mfu


@dataclasses.dataclass
class Benchmark:
    """What ``benchmark`` times: ``fn(batch, carry)`` (``chainable``) on
    ``batch``, the device tensors of the loader's first batch."""

    model: torch.nn.Module
    batch: Dict[str, torch.Tensor]
    carry_key: str
    fn: Callable


def prepare_benchmark(config, benchmark_type: str, device) -> Benchmark:
    """The JAX command's set-up (``cli/__init__.py:419-459``): the corpus's
    stats and lookup tables, the device keys of the training loader's first
    batch at seed 0, a model seeded with 0, and its forward:
    ``training`` is the deterministic training forward (the JAX package's
    ``inference=False, deterministic=True``; no loss), ``inference`` the
    free-running forward at ``model.max_mel_length``. Both run under
    ``torch.inference_mode``."""
    from ..dataset import BucketedLoader, load_datasets
    from ..models.fastspeech2 import FastSpeech2
    from ..preprocessing.stats import load_stats
    from ..text import TextProcessor
    from ..text.lookups import lookuptables_from_config
    from ..training.loop import set_variance_bins
    from ..training.state import init_like_flax
    from ..training.step import batch_to_device

    if benchmark_type not in BENCHMARK_TYPES:
        raise ValueError(f"benchmark_type {benchmark_type!r} not in {BENCHMARK_TYPES}")
    stats = load_stats(Path(config.preprocessing.save_dir) / "stats.json")
    lang2id, speaker2id = lookuptables_from_config(config)
    tp = TextProcessor(config.text)
    train_ds, _ = load_datasets(config, lang2id, speaker2id)
    loader = BucketedLoader(train_ds, config.training.batch_size, seed=0,
                            max_mel_length=config.model.max_mel_length)
    batch = batch_to_device(next(iter(loader)), device)

    model = FastSpeech2(config, n_symbols=len(tp.symbols),
                        n_speakers=max(len(speaker2id), 1), n_languages=max(len(lang2id), 1))
    init_like_flax(model, 0)
    set_variance_bins(model, stats, config)
    model = model.to(device).eval()
    max_target_len = config.model.max_mel_length

    if benchmark_type == "training":
        def apply_fn(b):
            return model.forward_train(b, None)["output"]
    else:
        def apply_fn(b):
            return model.forward(b["text"], b["src_lens"], max_target_len,
                                 speaker_id=b.get("speaker_id"),
                                 language_id=b.get("language_id"), pfs=b.get("pfs"),
                                 mel_style_reference=b.get("mel_style_reference"))["output"]

    carry_key = "pitch" if "pitch" in batch else "mel"
    chained = chainable(apply_fn, carry_key)

    def fn(b, carry):
        with torch.inference_mode():
            return chained(b, carry)

    return Benchmark(model=model, batch=batch, carry_key=carry_key, fn=fn)
