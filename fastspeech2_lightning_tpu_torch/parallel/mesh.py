"""The (data, model) process layout (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package lays one process's devices, or several hosts' devices, out
as a ``Mesh(("data", "model"))`` and lets GSPMD insert the collectives. The
port runs one process per device under ``torch.distributed`` and inserts
them itself. Rank r has data rank ``r // model_parallel`` and model rank
``r % model_parallel``, which is ``make_mesh``'s ``reshape(n // mp, mp)``;
the ranks of one model rank form a data group, the ranks of one data rank a
model group (both ``torch.distributed.new_group``s). A group of one rank is
held as None and every collective over it is skipped, so a run of one
process, with or without a process group, computes what it computed before
the layout existed, bit for bit.

Batches are split over the data group: each data rank takes a contiguous
block of rows of the global batch (``batch_rows``; the loaders collate only
those rows). Parameters are replicated, except the Megatron pairs of the
JAX package's ``_PARAM_RULES`` (``mesh.py:51-80``), which are split over
the model group (``shard_plan``, ``shard_model``):

- ``ffn1``/``ffn2`` ``linear1`` (``sequential.1``): rows of the weight and
  the bias (column parallel);
- ``ffn1``/``ffn2`` ``linear2`` (``sequential.4``): columns of the weight,
  the bias replicated (row parallel);
- ``in_proj_weight`` and ``in_proj_bias``: by head, each rank holding its
  heads' q, k and v rows; ``out_proj``: columns of the weight;
- ``text_input_layer`` (the embedding, not a phonological-feature model's
  Linear): the embedding dim.

JAX stores a Dense kernel as [in, out] and torch a weight as [out, in], so
JAX's ``P(None, "model")`` is dim 0 of a torch weight. As ``_validated_spec``
(``mesh.py:121``) does, a tensor whose split dim does not divide by the
model size stays replicated. The port splits attention by head where JAX
splits the fused qkv columns evenly, so attention stays replicated when
``heads % model_parallel != 0`` even where JAX's 3d columns would divide:
that changes which rank holds what, but no value.

A rank installs its layout once, ``set_layout(make_layout(model_parallel))``
(``Trainer`` does), and the layers, losses, steps and optimizer read it
through ``layout()``; no function takes a layout as an argument.

The reference-layout state_dict stays the exchange format: ``shard_state_dict``
takes a rank's slices of a full one, ``gather_state_dict`` rebuilds the full
one from the ranks' slices, so checkpoints look the same whatever wrote
them."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

ROWS, COLS, HEADS = "rows", "cols", "heads"


@dataclasses.dataclass(frozen=True)
class ParallelLayout:
    """World, data and model sizes and ranks of this process, and its data
    and model groups (None where the group holds this rank alone)."""

    world_size: int = 1
    rank: int = 0
    data_size: int = 1
    data_rank: int = 0
    model_size: int = 1
    model_rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.world_size > 1


TRIVIAL = ParallelLayout()
# The process's layout, as torch.distributed's default group is the
# process's: a rank installs one layout (``set_layout``) for its whole life,
# and every layer, loss, step and optimizer reads it through ``layout()``.
_current: Optional[ParallelLayout] = None


def layout() -> ParallelLayout:
    """The layout ``set_layout``/``use_layout`` installed; without one, the
    trivial layout of one process. A process group of more than one rank
    with no layout installed raises: which ranks split the batch and which
    the model is the caller's to say (``make_layout``)."""
    if _current is not None:
        return _current
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise RuntimeError(f"a process group of {dist.get_world_size()} ranks and no "
                           f"layout installed: call set_layout(make_layout(model_parallel))")
    return TRIVIAL


def set_layout(new: Optional[ParallelLayout]) -> None:
    global _current
    _current = new


@contextlib.contextmanager
def use_layout(new: ParallelLayout) -> Iterator[ParallelLayout]:
    """Install `new` as ``layout()`` for the body."""
    old = _current
    set_layout(new)
    try:
        yield new
    finally:
        set_layout(old)


def make_layout(model_parallel: int = 1) -> ParallelLayout:
    """The layout of this process in the current process group (every rank
    calls it, in the same order: ``new_group`` is collective). Without a
    process group: the trivial layout, and model_parallel above 1 raises."""
    if not (dist.is_available() and dist.is_initialized()):
        if model_parallel != 1:
            raise ValueError(f"model_parallel={model_parallel} needs a process group of "
                             f"{model_parallel} or more ranks (launch with torchrun)")
        return TRIVIAL
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world % model_parallel != 0:
        raise ValueError(f"{world} ranks not divisible by model_parallel={model_parallel}")
    mp = model_parallel
    n_data = world // mp
    data_group = model_group = None
    if n_data > 1:
        if mp == 1:
            data_group = dist.group.WORLD
        else:
            for m in range(mp):  # every rank creates every group
                g = dist.new_group([d * mp + m for d in range(n_data)])
                if rank % mp == m:
                    data_group = g
    if mp > 1:
        if n_data == 1:
            model_group = dist.group.WORLD
        else:
            for d in range(n_data):
                g = dist.new_group([d * mp + m for m in range(mp)])
                if rank // mp == d:
                    model_group = g
    return ParallelLayout(world_size=world, rank=rank, data_size=n_data, data_rank=rank // mp,
                          model_size=mp, model_rank=rank % mp, data_group=data_group,
                          model_group=model_group)


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if os.environ.get(name) else None


def init_distributed(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Join the process group this process was launched into and return
    its device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo when
    `device` is "cpu". torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` are read, and so are the JAX CLI's
    ``FS2T_COORDINATOR_ADDRESS`` (host:port), ``FS2T_NUM_PROCESSES`` and
    ``FS2T_PROCESS_ID``, so one launch environment serves both packages.
    Where a process group exists already, it is used as it is."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; distributed training runs on the "
                           "GPU unless called with device='cpu'")
    local = _env_int("LOCAL_RANK")
    if not dist.is_initialized():
        coordinator = os.environ.get("FS2T_COORDINATOR_ADDRESS")
        if coordinator:
            init_method = f"tcp://{coordinator}"
            world, rank = _env_int("FS2T_NUM_PROCESSES"), _env_int("FS2T_PROCESS_ID")
        elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
            init_method = "env://"
            world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        else:
            raise ValueError(
                "distributed training needs a launcher's environment: torchrun's RANK, "
                "WORLD_SIZE, MASTER_ADDR and MASTER_PORT, or FS2T_COORDINATOR_ADDRESS, "
                "FS2T_NUM_PROCESSES and FS2T_PROCESS_ID")
        if world is None or rank is None:
            raise ValueError("the launch environment names no world size or rank")
        if not cpu:  # NCCL binds the current device
            local = rank % torch.cuda.device_count() if local is None else local
            torch.cuda.set_device(local)
        dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method,
                                world_size=world, rank=rank)
    if cpu:
        return torch.device("cpu")
    if local is None:
        local = dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


# --- collectives (each a no-op over a group of one rank, held as None) ---

def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """In-place sum (or `op`) of `t` over `group`; returns `t`."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """`t` of every rank of `group`, in rank order."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """`t` of global rank `src`, in place on every rank of `group`."""
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.broadcast(t, src, group=group)
    return t


def barrier(group=None) -> None:
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def batch_rows(batch: dict) -> dict:
    """This data rank's contiguous rows of a global batch (tensors, arrays
    and lists with a leading batch axis; scalars as they are)."""
    lay = layout()
    if lay.data_size == 1:
        return batch
    n = None
    for v in batch.values():
        if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim > 0:
            n = v.shape[0]
            break
    if n is None or n % lay.data_size:
        raise ValueError(f"global batch of {n} rows does not divide over "
                         f"{lay.data_size} data ranks")
    per = n // lay.data_size
    lo, hi = lay.data_rank * per, (lay.data_rank + 1) * per
    out = {}
    for k, v in batch.items():
        if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim > 0:
            out[k] = v[lo:hi]
        elif isinstance(v, list):
            out[k] = v[lo:hi]
        else:
            out[k] = v
    return out


# --- Megatron parameter rules over the reference layout ---

_PARAM_RULES = [
    (r"(.*\.)?ffn\d\.sequential\.1\.weight$", ROWS),
    (r"(.*\.)?ffn\d\.sequential\.1\.bias$", ROWS),
    (r"(.*\.)?ffn\d\.sequential\.4\.weight$", COLS),
    (r"(.*\.)?self_attn\.in_proj_weight$", HEADS),
    (r"(.*\.)?self_attn\.in_proj_bias$", HEADS),
    (r"(.*\.)?self_attn\.out_proj\.weight$", COLS),
    (r"text_input_layer\.weight$", COLS),
]


def param_rule(name: str) -> Optional[str]:
    """The split a reference-layout parameter name takes under tensor
    parallelism (ROWS, COLS or HEADS), or None (replicated)."""
    for pattern, kind in _PARAM_RULES:
        if re.match(pattern, name):
            return kind
    return None


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    kind: str  # ROWS, COLS or HEADS
    full_shape: tuple


def shard_plan(model: torch.nn.Module, model_size: int) -> Dict[str, ShardSpec]:
    """{name: ShardSpec} of the parameters of a full-size `model` that a
    model group of `model_size` ranks splits: the rules above, where the
    split dim divides by `model_size` (for attention: where the heads do),
    and the text embedding only when it is an embedding."""
    from ..models.conformer import SelfAttention
    from ..models.layers import Embedding

    if model_size == 1:
        return {}
    modules = dict(model.named_modules())
    plan = {}
    for name, p in model.named_parameters():
        kind = param_rule(name)
        if kind is None:
            continue
        owner = modules[name.rsplit(".", 1)[0]]
        if name.startswith("text_input_layer.") and not isinstance(owner, Embedding):
            continue
        if kind == HEADS or name.endswith("out_proj.weight"):
            # attention splits by head (out_proj's columns with its heads)
            attn = modules[name.rsplit(".", 1 if kind == HEADS else 2)[0]]
            if attn.heads % model_size:
                continue
        dim = 1 if kind == COLS else 0
        if p.shape[dim] % model_size:
            continue
        plan[name] = ShardSpec(kind, tuple(p.shape))
    return plan


def shard_tensor(t, spec: ShardSpec, model_rank: int, model_size: int):
    """`model_rank`'s slice of a full tensor under `spec` (a view)."""
    if spec.kind == HEADS:
        third = t.shape[0] // 3
        n = third // model_size
        rest = tuple(t.shape[1:])
        return t.reshape((3, third) + rest)[:, model_rank * n:(model_rank + 1) * n].reshape(
            (3 * n,) + rest)
    dim = 1 if spec.kind == COLS else 0
    n = t.shape[dim] // model_size
    return t.narrow(dim, model_rank * n, n)


def unshard_tensor(parts: List[torch.Tensor], spec: ShardSpec) -> torch.Tensor:
    """The full tensor from its slices in model-rank order."""
    if spec.kind == HEADS:
        rest = tuple(parts[0].shape[1:])
        return torch.cat([p.reshape((3, p.shape[0] // 3) + rest) for p in parts],
                         dim=1).reshape(spec.full_shape)
    return torch.cat(parts, dim=1 if spec.kind == COLS else 0)


def shard_state_dict(state_dict: dict, plan: Dict[str, ShardSpec]) -> dict:
    """This model rank's slices of a full reference-layout state_dict
    (tensors or arrays; entries the plan does not name as they are)."""
    lay = layout()
    if not plan:
        return state_dict
    out = dict(state_dict)
    for name, spec in plan.items():
        if name in out:
            t = out[name]
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.asarray(t))
            out[name] = shard_tensor(t, spec, lay.model_rank, lay.model_size).contiguous()
    return out


def gather_state_dict(state_dict: dict, plan: Dict[str, ShardSpec]) -> dict:
    """The full reference-layout state_dict from every model rank's slices
    (collective over the model group: every rank calls it)."""
    lay = layout()
    if not plan:
        return state_dict
    out = dict(state_dict)
    for name in sorted(plan):  # one order on every rank
        if name in out:
            out[name] = unshard_tensor(all_gather(out[name].detach(), lay.model_group),
                                       plan[name])
    return out


def shard_model(model: torch.nn.Module) -> Dict[str, ShardSpec]:
    """Split a full-size `model` over the layout's model group in place: each
    planned parameter keeps this rank's slice, and the modules that hold
    them switch to their tensor-parallel forward (``tensor_parallel.py``).
    Stores the plan as ``model.parallel_plan`` and returns it."""
    from ..models.conformer import FeedForwardModule, SelfAttention
    from ..models.layers import Embedding
    from .tensor_parallel import ColumnParallelLinear, RowParallelLinear

    plan = shard_plan(model, layout().model_size)
    model.parallel_plan = plan
    if not plan:
        return plan
    for name, module in list(model.named_modules()):
        if isinstance(module, FeedForwardModule) and f"{name}.sequential.1.weight" in plan:
            s = module.sequential
            s[1] = ColumnParallelLinear.from_linear(s[1])
            s[4] = RowParallelLinear.from_linear(s[4])
        elif isinstance(module, SelfAttention) and f"{name}.in_proj_weight" in plan:
            module.shard()
        elif isinstance(module, Embedding) and f"{name}.weight" in plan:
            module.shard()
    return plan
