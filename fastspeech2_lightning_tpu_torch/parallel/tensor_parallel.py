"""Megatron tensor parallelism over the model group, and the sums over the
data group that need a gradient (in the JAX package GSPMD inserts both from
``parallel/mesh.py``'s specs).

- ``copy_to_group``: identity forward, gradient summed over the group
  backward (the input of a column-parallel matmul);
- ``reduce_from_group``: sum over the group forward, identity backward (the
  output of a row-parallel matmul);
- ``all_reduce_sum``: sum forward and backward (BatchNorm's batch
  statistics over the data group: each rank's loss depends on every rank's
  rows through them);
- ``gather_last_dim``: all-gather along the last dim forward, this rank's
  slice of the gradient backward (the split text embedding).

Each is the identity over a group of one rank (held as None); a bf16 or
f16 sum travels in f32 and is rounded once to the tensor's dtype.
``ColumnParallelLinear`` and ``RowParallelLinear`` are the port's ``Linear``
split over the installed layout's model group; they take a full-size
``Linear`` and keep this rank's slice of its weight."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.layers import Linear
from .mesh import COLS, ROWS, ShardSpec, layout, shard_tensor


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    out = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n].contiguous(), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherLastDim.apply(x, group)


class ColumnParallelLinear(Linear):
    """A ``Linear`` whose output features (weight rows and bias) are split
    over the model group: the input is copied into the group, the output
    stays split (the dropout after it draws the full width)."""

    @classmethod
    def from_linear(cls, full: Linear) -> "ColumnParallelLinear":
        lay = layout()
        out_f = full.out_features // lay.model_size
        m = cls(full.in_features, out_f, bias=full.bias is not None, dtype=full.compute_dtype)
        m.to(full.weight.device)
        spec = ShardSpec(ROWS, tuple(full.weight.shape))
        with torch.no_grad():
            m.weight.copy_(shard_tensor(full.weight, spec, lay.model_rank, lay.model_size))
            if full.bias is not None:
                m.bias.copy_(shard_tensor(full.bias, spec, lay.model_rank, lay.model_size))
        return m

    def forward(self, x):
        return super().forward(copy_to_group(x, layout().model_group))


class RowParallelLinear(Linear):
    """A ``Linear`` whose input features (weight columns) are split over the
    model group: each rank multiplies its slice of the input, the partial
    products are summed over the group, then the replicated bias is
    added."""

    @classmethod
    def from_linear(cls, full: Linear) -> "RowParallelLinear":
        lay = layout()
        in_f = full.in_features // lay.model_size
        m = cls(in_f, full.out_features, bias=full.bias is not None, dtype=full.compute_dtype)
        m.to(full.weight.device)
        spec = ShardSpec(COLS, tuple(full.weight.shape))
        with torch.no_grad():
            m.weight.copy_(shard_tensor(full.weight, spec, lay.model_rank, lay.model_size))
            if full.bias is not None:
                m.bias.copy_(full.bias)
        return m

    def forward(self, x):
        dt = self.compute_dtype
        y = reduce_from_group(F.linear(x.to(dt), self.weight.to(dt)), layout().model_group)
        return y if self.bias is None else y + self.bias.to(dt)
