"""One training step and one evaluation step (counterparts of the JAX
package's ``training/step.py`` train and eval steps). The train step: forward
with dropout, loss, backward, clip + AdamW + Noam (+ freeze), EMA of the
parameters, and the gradient norm before clipping among the losses. The eval
step: the same forward without a generator (no dropout, BatchNorm on its
running statistics, attention at p 0, the CTC alpha chain alone) and loss.

Under the installed layout (``parallel.layout()``) each rank computes on
its rows of the global batch (the trainer's loader collates them; a global
device batch gives them up through ``parallel.batch_rows``): its losses are
its shares of the global batch's (``loss.py``), its gradients are summed
over the data group (``state.py``), and the losses returned are the shares
summed over the data group, the global batch's. The step's generator
depends on (seed, step) only, so it is the same on every rank, and every
random draw takes the global tensor's bits (``layers.fast_dropout``,
``conformer.SelfAttention``).

``TrainStepGraph`` is ``training.steps_per_call`` on a card (the JAX
package's ``make_multi_train_step``): the whole step (forward, loss,
backward, clip + AdamW + Noam, EMA) captured once per batch shape as a
CUDA graph and replayed once per batch of a call, each replay re-seeding
the graph's generator with the step's (seed, step), so it draws what the
eager step draws."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import build
from ..parallel.mesh import all_reduce
from ..parallel.mesh import layout as parallel_layout
from .loss import bin_warmup_factor, compute_loss
from .state import AdamWNoam

# batch arrays the device step reads (the loader's host-only fields stay behind)
DEVICE_KEYS = ("text", "src_lens", "mel", "mel_lens", "pitch", "energy", "attn_prior",
               "duration", "speaker_id", "language_id", "sample_weight", "pfs",
               "mel_style_reference")


def batch_to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    out = {}
    for key in DEVICE_KEYS:
        if batch.get(key) is not None:
            out[key] = torch.from_numpy(np.ascontiguousarray(batch[key])).to(device)
    return out


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step `step`, from (seed, step), as the JAX step
    folds its index into the dropout rng (``step.py:62``)."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A new generator of step `step` (``step_seed``)."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _global_losses(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' loss shares summed over the data group (one all-reduce)."""
    out = {k: v.detach() for k, v in losses.items()}
    group = parallel_layout().data_group
    if group is None:
        return out
    names = [k for k in out if k != "grad_norm"]
    vec = all_reduce(torch.stack([out[k].float() for k in names]), group)
    out.update(zip(names, vec))
    return out


def update_ema(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, in place, in two foreach
    products and a foreach sum (each rounded as the written-out form)."""
    with torch.no_grad():
        new = torch._foreach_mul(params, 1.0 - decay)
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, new)


def _step(model, optimizer: AdamWNoam, config, batch: Dict[str, torch.Tensor],
          gen: torch.Generator, epoch: int, ema: Optional[List[torch.Tensor]],
          bin_warmup: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The body of a train step, drawing from `gen`: what ``train_step`` runs
    and ``TrainStepGraph`` captures."""
    output = model.forward_train(batch, gen)
    losses = compute_loss(config, output, batch, epoch, bin_warmup)
    for p in optimizer.params:
        p.grad = None
    losses["total"].backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in optimizer.params]
    losses["grad_norm"] = optimizer.step(grads)
    if ema is not None:
        update_ema(ema, optimizer.params, config.training.ema_decay)
    return _global_losses(losses)


def train_step(model, optimizer: AdamWNoam, config, batch: Dict[str, torch.Tensor],
               step: int, epoch: int, ema: Optional[List[torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """Update `model` (and `ema`, one tensor per parameter) in place from one
    device batch, this rank's rows; returns the losses as 0-d tensors."""
    gen = step_generator(config.training.seed, step, batch["text"].device)
    return _step(model, optimizer, config, batch, gen, epoch, ema)


def batch_signature(batch: Dict[str, torch.Tensor]) -> tuple:
    """The (key, shape, dtype) of every tensor of a device batch: one
    captured graph serves the batches of one signature."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


class _Captured:
    """One captured step: its graph, static inputs, loss rows and row index,
    the gradients it writes (held so the pool keeps their memory), and the
    kernel launches it makes a replay."""

    def __init__(self, graph, inputs, rows, row, grads, counts):
        self.graph, self.inputs, self.rows, self.row = graph, inputs, rows, row
        self.grads, self.counts = grads, counts


class TrainStepGraph:
    """``training.steps_per_call`` on a CUDA device: runs of k same-shape
    batches as replays of one captured whole train step.

    A batch signature (``batch_signature``) is captured the first time a
    call brings it: the call's first batch runs as the eager step on a side
    stream (the warm-up the CUDA-graph docs ask for, a real step), then the
    step is captured into a graph of its own; every graph shares one memory
    pool (``BucketedLoader``'s static buckets bound the signatures). A
    replay copies its batch into the graph's static inputs, re-seeds the
    graph's generator with ``step_seed(seed, step)`` (registered with each
    graph where torch has ``CUDAGraph.register_generator_state``, else the
    device's default CUDA generator, which graphs track), fills the
    binarization warmup of the epoch, and writes its losses into row i of
    the graph's [k, n_losses] buffer, which the caller fetches once a call.

    A capture runs nothing, so its Python side effects are kept out: the
    optimizer raises its host count outside a capture only (``run`` raises
    it a replay), and the kernels' launch counts taken during the capture
    (``kernels.build.recording``) are added back at every replay. A failed
    capture or replay raises; nothing falls back to the eager step."""

    def __init__(self, model, optimizer: AdamWNoam, config,
                 ema: Optional[List[torch.Tensor]] = None):
        self.model, self.optimizer, self.config, self.ema = model, optimizer, config, ema
        self.device = optimizer.device
        if self.device.type != "cuda":
            raise ValueError(f"TrainStepGraph captures CUDA graphs; the model is on "
                             f"{self.device}")
        self.registers = hasattr(torch.cuda.CUDAGraph, "register_generator_state")
        index = self.device.index if self.device.index is not None else \
            torch.cuda.current_device()
        self.gen = (torch.Generator(device=self.device) if self.registers
                    else torch.cuda.default_generators[index])
        self.pool = torch.cuda.graph_pool_handle()
        self.warmup = torch.zeros((), dtype=torch.float32, device=self.device)
        self.graphs: Dict[tuple, _Captured] = {}
        self.names: Optional[List[str]] = None
        self.capture_ms: List[float] = []

    def _capture(self, batch: Dict[str, torch.Tensor], n: int) -> _Captured:
        inputs = {k: v.clone() for k, v in batch.items()}  # outside the pool
        rows = torch.zeros((n, len(self.names)), dtype=torch.float32, device=self.device)
        row = torch.zeros(1, dtype=torch.int64, device=self.device)
        graph = torch.cuda.CUDAGraph()
        if self.registers:
            graph.register_generator_state(self.gen)
        params = self.optimizer.params
        for p in params:  # the captured backward writes fresh gradients in the pool
            p.grad = None
        t0 = time.perf_counter()
        with build.recording() as counts:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                losses = _step(self.model, self.optimizer, self.config, inputs, self.gen, 0,
                               self.ema, bin_warmup=self.warmup)
                vec = torch.stack([losses[k].float() for k in self.names])
                rows.index_copy_(0, row, vec[None])
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        return _Captured(graph, inputs, rows, row, grads, counts)

    def run(self, batches: Dict[str, torch.Tensor], step: int, epoch: int
            ) -> Tuple[List[str], torch.Tensor]:
        """Steps step + 1 .. step + n on `batches` (device tensors stacked
        [n, ...]); returns (loss names, [n, len(names)] f32 losses on the
        device, the graph's buffer: fetch it before the next call)."""
        n = next(iter(batches.values())).shape[0]
        first = {k: v[0] for k, v in batches.items()}
        sig = (n, batch_signature(first))
        captured = self.graphs.get(sig)
        start, warm = 0, None
        if captured is None:
            # the warm-up: the call's first step, eagerly, on a side stream
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                losses = train_step(self.model, self.optimizer, self.config, first, step,
                                    epoch, self.ema)
                self.names = self.names or list(losses)
                warm = torch.stack([losses[k].float() for k in self.names])
            current.wait_stream(side)
            captured = self.graphs[sig] = self._capture(first, n)
            start = 1
        self.warmup.fill_(bin_warmup_factor(self.config.training, epoch))
        seed = self.config.training.seed
        for i in range(start, n):
            for k, buf in captured.inputs.items():
                buf.copy_(batches[k][i])
            captured.row.fill_(i)
            self.gen.manual_seed(step_seed(seed, step + i))
            captured.graph.replay()
            self.optimizer.count += 1
            build.add(captured.counts)
        if warm is not None:
            captured.rows[0].copy_(warm)
        return self.names, captured.rows


def eval_step(model, config, batch: Dict[str, torch.Tensor], epoch: int
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(losses as 0-d tensors, model output) of one device batch, this
    rank's rows, without gradients (``make_eval_step``,
    ``step.py:110-118``); the output holds this rank's rows, the losses are
    the global batch's."""
    with torch.no_grad():
        output = model.forward_train(batch, None)
        losses = compute_loss(config, output, batch, epoch)
    return _global_losses(losses), output
