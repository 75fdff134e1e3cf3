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
``conformer.SelfAttention``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import all_reduce
from ..parallel.mesh import layout as parallel_layout
from .loss import compute_loss
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


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`: seeded from (seed, step), as the JAX
    step folds its index into the dropout rng (``step.py:62``)."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


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


def train_step(model, optimizer: AdamWNoam, config, batch: Dict[str, torch.Tensor],
               step: int, epoch: int, ema: Optional[List[torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """Update `model` (and `ema`, one tensor per parameter) in place from one
    device batch, this rank's rows; returns the losses as 0-d tensors."""
    device = batch["text"].device
    gen = step_generator(config.training.seed, step, device)
    output = model.forward_train(batch, gen)
    losses = compute_loss(config, output, batch, epoch)
    for p in optimizer.params:
        p.grad = None
    losses["total"].backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in optimizer.params]
    losses["grad_norm"] = optimizer.step(grads)
    if ema is not None:
        decay = config.training.ema_decay
        with torch.no_grad():
            for e, p in zip(ema, optimizer.params):
                e.copy_(decay * e + (1.0 - decay) * p)
    return _global_losses(losses)


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
