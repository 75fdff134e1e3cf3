"""Parameters and optimizer of the training step (counterpart of the JAX
package's ``training/state.py``).

The trainable parameters are exactly the JAX package's params (buffers such
as the variance bins, ``inv_freq`` and the BatchNorm running statistics are
not), so the global gradient norm and the weight decay see the same
elements. The update is optax's chain, written out:
``clip_by_global_norm`` (g * clip / norm only when norm >= clip), AdamW
(``scale_by_adam`` with bias correction, decoupled weight decay on every
parameter, learning rate from the Noam schedule of the update count), then
zero updates for the ``freeze_components`` subtrees.

Under a data-parallel layout the gradients are summed over the data group
first (flattened into buckets, one all-reduce a bucket): each rank's loss is
its share of the global batch's (``loss.py``), so the sum is the
one-process gradient. The clip's global norm takes the replicated
gradients once and the model-split ones' squares summed over the model
group, as ``optax.clip_by_global_norm`` sees the whole tree.
``ZeroAdamWNoam`` is ``training.fused_optimizer`` (the JAX package's
``fused_optim.py`` with ``parallel/mesh.py opt_pspec_tree``): one flat
parameter vector, each data rank holding the moments of a contiguous slice
and updating that slice, then gathering the updated slices (ZeRO-1). Both
hand their moments out, and take them in, per parameter in the full
reference layout, which is what a checkpoint holds."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..models.attention import ConvAttention
from ..models.conformer import SelfAttention
from ..models.gst import StyleTokenLayer
from ..parallel.mesh import all_gather, all_reduce, gather_state_dict
from ..parallel.mesh import layout as parallel_layout
from ..parallel.mesh import shard_state_dict


def noam_lr(base_lr: float, warmup_steps: int, count: int) -> float:
    """base_lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5), with the
    update count clamped to step >= 1 (``state.py:22-32``)."""
    step = max(float(count), 1.0)
    return base_lr * warmup_steps ** 0.5 * min(step ** -0.5, step * warmup_steps ** -1.5)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def freeze_mask(names: List[str], frozen: List[str]) -> List[bool]:
    """Per parameter: whether it lies under a frozen top-level module.
    Unknown names raise, so a typo cannot fine-tune what was meant to stay
    fixed (``state.py:44-60``)."""
    tops = sorted({n.split(".")[0] for n in names})
    unknown = set(frozen) - set(tops)
    if unknown:
        raise ValueError(
            f"freeze_components {sorted(unknown)} not found among model parameter "
            f"subtrees {tops}"
        )
    return [n.split(".")[0] in frozen for n in names]


BUCKET_NUMEL = 1 << 23  # gradient elements an all-reduce (32 MiB of f32)


def _all_reduce_buckets(tensors: List[torch.Tensor], group) -> None:
    """Sum `tensors` over `group` in place, packed into flat buckets."""
    bucket: List[torch.Tensor] = []
    size = 0
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel()
        if size >= BUCKET_NUMEL or i == len(tensors) - 1:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            all_reduce(flat, group)
            for b, piece in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(piece.view_as(b))
            bucket, size = [], 0


class AdamWNoam:
    """Clip + AdamW + Noam + freeze over a model's named parameters. Under
    the installed layout (``parallel.layout()``) the gradients are summed
    over the data group, and the parameters `split` names
    (``model.parallel_plan``) are this model rank's slices."""

    def __init__(self, named_params: List[Tuple[str, nn.Parameter]], training_config,
                 split: Optional[dict] = None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        opt = training_config.optimizer
        self.lr, self.warmup = opt.learning_rate, opt.warmup_steps
        self.b1, self.b2 = opt.betas
        self.eps, self.weight_decay = opt.eps, opt.weight_decay
        self.clip = training_config.gradient_clip_val
        self.frozen = freeze_mask(self.names, list(training_config.freeze_components))
        self.layout = parallel_layout()
        self.split = dict(split or {})
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        group = self.layout.model_group
        if group is None or not self.split:
            return global_norm(grads)
        sq = [(g.float() * g.float()).sum() for g in grads]
        repl = sum(s for n, s in zip(self.names, sq) if n not in self.split)
        part = torch.stack([s for n, s in zip(self.names, sq) if n in self.split]).sum()
        return torch.sqrt(repl + all_reduce(part, group))

    def _prepare(self, grads: List[torch.Tensor]):
        """Sum the gradients over the data group; (norm, keep, c1, c2, lr)."""
        if self.layout.data_group is not None:
            _all_reduce_buckets(grads, self.layout.data_group)
        norm = self._global_norm(grads)
        count_inc = self.count + 1
        # bias corrections in f32, as optax computes them
        c1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** count_inc
        c2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** count_inc
        lr = torch.tensor(noam_lr(self.lr, self.warmup, self.count), dtype=torch.float32)
        return norm, norm < self.clip, c1, c2, lr

    def _adam(self, p, g, mu, nu, norm, keep, c1, c2, lr):
        """The update of one tensor (mu and nu updated in place)."""
        b1, b2 = self.b1, self.b2
        g = torch.where(keep, g, (g / norm) * self.clip)
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        update = (mu / c1.to(p.device)) / (torch.sqrt(nu / c2.to(p.device)) + self.eps)
        return (update + self.weight_decay * p) * (-lr.to(p.device))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Apply one update from `grads` (one per parameter, this rank's
        share; summed over the data group in place); returns the global norm
        of the gradients before clipping."""
        norm, keep, c1, c2, lr = self._prepare(grads)
        for p, g, mu, nu, frozen in zip(self.params, grads, self.mu, self.nu, self.frozen):
            update = self._adam(p, g, mu, nu, norm, keep, c1, c2, lr)
            if not frozen:
                p.add_(update)
        self.count += 1
        return norm

    def moments(self) -> Tuple[dict, dict]:
        """(mu, nu) by parameter name in the full reference layout
        (collective over the model group when parameters are split)."""
        mu, nu = dict(zip(self.names, self.mu)), dict(zip(self.names, self.nu))
        return gather_state_dict(mu, self.split), gather_state_dict(nu, self.split)

    @torch.no_grad()
    def load_state(self, mu: dict, nu: dict, count: int) -> None:
        """Set the moments (tensors or arrays by parameter name in the full
        reference layout, exactly this optimizer's names) and the update
        count."""
        for moments, given in ((self.mu, mu), (self.nu, nu)):
            if set(given) != set(self.names):
                raise KeyError(f"optimizer state names differ from the model's: "
                               f"{sorted(set(given) ^ set(self.names))[:5]}")
            given = shard_state_dict(given, self.split)
            for name, m in zip(self.names, moments):
                m.copy_(torch.as_tensor(given[name]))
        self.count = int(count)


class ZeroAdamWNoam(AdamWNoam):
    """``training.fused_optimizer``: the update over one flat parameter
    vector, split into equal contiguous slices over the data group (padded
    to a multiple of its size). Each data rank keeps ``mu``/``nu`` of its
    slice only, updates its slice of the parameters, and the slices are
    all-gathered back into every rank's parameters. Data parallel only, as
    in JAX: with parameters split over a model group the trainer uses
    ``AdamWNoam``."""

    def __init__(self, named_params, training_config, split=None):
        super().__init__(named_params, training_config, split)
        if self.split:
            raise ValueError("the fused (ZeRO-1) optimizer takes no model-split parameters")
        lay = self.layout
        numels = [p.numel() for p in self.params]
        self.slice_numel = -(-sum(numels) // lay.data_size)
        self.lo = lay.data_rank * self.slice_numel
        self.padded = self.slice_numel * lay.data_size
        self.pieces = numels + [self.padded - sum(numels)]  # the flat vector's split, padding last
        device = self.params[0].device
        frozen = torch.cat([torch.full((n,), f, dtype=torch.bool)
                            for n, f in zip(self.pieces, self.frozen + [True])])
        self.frozen_slice = frozen[self.lo:self.lo + self.slice_numel].to(device)
        self.mu = [torch.zeros(self.slice_numel, device=device)]
        self.nu = [torch.zeros(self.slice_numel, device=device)]

    def _flat(self, tensors) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        return torch.cat([flat, flat.new_zeros(self.padded - flat.numel())])

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norm, keep, c1, c2, lr = self._prepare(grads)
        hi = self.lo + self.slice_numel
        g = self._flat(grads)[self.lo:hi]
        p = self._flat(self.params)[self.lo:hi]
        update = self._adam(p, g, self.mu[0], self.nu[0], norm, keep, c1, c2, lr)
        p = p + torch.where(self.frozen_slice, torch.zeros_like(update), update)
        flat = torch.cat(all_gather(p, self.layout.data_group))
        for param, piece in zip(self.params, flat.split(self.pieces)):
            param.copy_(piece.view_as(param))
        self.count += 1
        return norm

    def _full(self, part: torch.Tensor) -> dict:
        flat = torch.cat(all_gather(part, self.layout.data_group))
        return {n: piece.view_as(p)
                for n, p, piece in zip(self.names, self.params, flat.split(self.pieces))}

    def moments(self) -> Tuple[dict, dict]:
        """(mu, nu) by parameter name, gathered from every data rank's slice
        (collective over the data group)."""
        return self._full(self.mu[0]), self._full(self.nu[0])

    @torch.no_grad()
    def load_state(self, mu: dict, nu: dict, count: int) -> None:
        for part, given in ((self.mu[0], mu), (self.nu[0], nu)):
            if set(given) != set(self.names):
                raise KeyError(f"optimizer state names differ from the model's: "
                               f"{sorted(set(given) ^ set(self.names))[:5]}")
            flat = self._flat([torch.as_tensor(given[n]) for n in self.names])
            part.copy_(flat[self.lo:self.lo + self.slice_numel])
        self.count = int(count)


def make_optimizer(model: nn.Module, training_config) -> AdamWNoam:
    """``ZeroAdamWNoam`` when ``training.fused_optimizer`` is set and no
    parameter is split over a model group (the JAX trainer's fallback under
    tensor parallelism, ``loop.py:434-438``), else ``AdamWNoam``."""
    split = getattr(model, "parallel_plan", None) or {}
    cls = ZeroAdamWNoam if training_config.fused_optimizer and not split else AdamWNoam
    return cls(list(model.named_parameters()), training_config, split)


@torch.no_grad()
def init_like_flax(model: nn.Module, seed: int) -> None:
    """The JAX package's initial distributions (flax defaults): dense and
    conv kernels lecun-normal (truncated normal, std 1/sqrt(fan_in)), the
    alignment attention's convs xavier-uniform, embeddings normal with std
    1/sqrt(features), biases 0, norm scales 1; the style encoder's GRU with
    lecun-normal input kernels and orthogonal recurrent ones (each gate's
    apart), its tokens normal with std 1."""
    gen = torch.Generator().manual_seed(seed)
    xavier = set()
    for name, module in model.named_modules():
        if isinstance(module, ConvAttention):
            xavier.update(id(m) for m in module.modules())

    def lecun(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)

    for name, module in model.named_modules():
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = module.weight[0].numel()
            if id(module) in xavier:
                nn.init.xavier_uniform_(module.weight, generator=gen)
            else:
                lecun(module.weight, fan_in)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            nn.init.normal_(module.weight, std=module.weight.shape[1] ** -0.5, generator=gen)
        elif isinstance(module, (nn.LayerNorm, nn.BatchNorm1d)):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, SelfAttention):
            lecun(module.in_proj_weight, module.in_proj_weight.shape[1])
            module.in_proj_bias.zero_()
        elif isinstance(module, nn.GRU):
            lecun(module.weight_ih_l0, module.weight_ih_l0.shape[1])
            for gate in module.weight_hh_l0.chunk(3):
                nn.init.orthogonal_(gate, generator=gen)
            module.bias_ih_l0.zero_()
            module.bias_hh_l0.zero_()
        elif isinstance(module, StyleTokenLayer):
            nn.init.normal_(module.gst_embs, std=1.0, generator=gen)
