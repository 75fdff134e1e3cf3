"""Data- and tensor-parallel training over ``torch.distributed``
(counterpart of the JAX package's ``parallel/``): the process layout, the
Megatron parameter rules and the collectives (``mesh.py``), the
tensor-parallel autograd functions and Linears (``tensor_parallel.py``),
and local process groups for tests and checks (``launch.py``)."""

from .mesh import (
    ParallelLayout,
    all_gather,
    all_reduce,
    barrier,
    batch_rows,
    broadcast,
    gather_state_dict,
    init_distributed,
    layout,
    make_layout,
    param_rule,
    set_layout,
    shard_model,
    shard_plan,
    shard_state_dict,
    use_layout,
)

__all__ = [
    "ParallelLayout", "all_gather", "all_reduce", "barrier", "batch_rows", "broadcast",
    "gather_state_dict", "init_distributed", "layout", "make_layout", "param_rule",
    "set_layout", "shard_model", "shard_plan", "shard_state_dict", "use_layout",
]
