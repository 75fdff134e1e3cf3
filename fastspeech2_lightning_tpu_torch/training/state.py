"""Parameters and optimizer of the training step (counterpart of the JAX
package's ``training/state.py``).

The trainable parameters are exactly the JAX package's params (buffers such
as the variance bins, ``inv_freq`` and the BatchNorm running statistics are
not), so the global gradient norm and the weight decay see the same
elements. The update is optax's chain, written out:
``clip_by_global_norm`` (g * clip / norm only when norm >= clip), AdamW
(``scale_by_adam`` with bias correction, decoupled weight decay on every
parameter, learning rate from the Noam schedule of the update count), then
zero updates for the ``freeze_components`` subtrees."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from ..models.attention import ConvAttention
from ..models.conformer import SelfAttention
from ..models.gst import StyleTokenLayer


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


class AdamWNoam:
    """Clip + AdamW + Noam + freeze over a model's named parameters."""

    def __init__(self, named_params: List[Tuple[str, nn.Parameter]], training_config):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        opt = training_config.optimizer
        self.lr, self.warmup = opt.learning_rate, opt.warmup_steps
        self.b1, self.b2 = opt.betas
        self.eps, self.weight_decay = opt.eps, opt.weight_decay
        self.clip = training_config.gradient_clip_val
        self.frozen = freeze_mask(self.names, list(training_config.freeze_components))
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Apply one update from `grads` (one per parameter); returns the
        global norm of the gradients before clipping."""
        norm = global_norm(grads)
        keep = norm < self.clip
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        # bias corrections in f32, as optax computes them
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count_inc
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count_inc
        lr = torch.tensor(noam_lr(self.lr, self.warmup, self.count), dtype=torch.float32)
        for p, g, mu, nu, frozen in zip(self.params, grads, self.mu, self.nu, self.frozen):
            g = torch.where(keep, g, (g / norm) * self.clip)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            update = (mu / c1.to(p.device)) / (torch.sqrt(nu / c2.to(p.device)) + self.eps)
            update = (update + self.weight_decay * p) * (-lr.to(p.device))
            if not frozen:
                p.add_(update)
        self.count = count_inc
        return norm

    @torch.no_grad()
    def load_state(self, mu: dict, nu: dict, count: int) -> None:
        """Set the moments (tensors or arrays by parameter name, exactly this
        optimizer's names) and the update count."""
        for moments, given in ((self.mu, mu), (self.nu, nu)):
            if set(given) != set(self.names):
                raise KeyError(f"optimizer state names differ from the model's: "
                               f"{sorted(set(given) ^ set(self.names))[:5]}")
            for name, m in zip(self.names, moments):
                m.copy_(torch.as_tensor(given[name]))
        self.count = int(count)


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
