"""Run a function in a process group of local processes (what the tests and
``chip_smoke.py`` use to hold W ranks against one process; a trainer is
launched by torchrun or the ``FS2T_*`` variables instead).

``run_local(fn, world_size, *args)`` starts `world_size` spawned processes,
each with one torch thread, joins them into a process group at a free
``tcp://127.0.0.1`` port (gloo by default: it takes CPU and CUDA tensors,
and NCCL refuses two ranks on one card), calls ``fn(rank, world_size,
*args)`` and returns the ranks' results in rank order. A rank that raises,
dies or outlives `timeout_s` fails the call, and every process is ended
before it returns.

``settled`` and ``update_errors`` hold one run's parameter updates to
another's, as the tests and ``chip_smoke.py`` compare W ranks with one
process."""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(x):
    """Tensors as numpy arrays (a queue would pass tensors through shared
    memory that dies with the process)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _child(fn, rank, world_size, port, backend, timeout_s, results, args):
    try:
        torch.set_num_threads(1)
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE=str(world_size), LOCAL_RANK="0")
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world_size, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, _to_host(out)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_local(fn: Callable, world_size: int, *args, backend: str = "gloo",
              timeout_s: float = 120.0) -> List[Any]:
    """[fn(0, W, *args), ..., fn(W - 1, W, *args)], each run in its own
    process of one process group; `fn` must be importable by name."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world_size, port, backend, timeout_s, results, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"did not finish in {timeout_s} s")
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a result may still be in the pipe: one more look first
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def settled(grads: Sequence[Tuple[Dict[str, Any], Dict[str, Any]]], noise: float = 1e-3
            ) -> Dict[str, np.ndarray]:
    """{name: bool array}: the elements whose gradient two runs agree on
    beyond rounding, in every (got, want) pair of `grads` (each step's
    gradients, or Adam's first moments, of the two runs): those where the
    two differ by at most `noise` of the wanted value, so that Adam's step
    there differs by about as little. The others hold a gradient that is
    zero to rounding, whose sign summation order decides and Adam turns into
    a step of the full rate."""
    keep = {}
    for g_got, g_want in grads:
        for name, w in g_want.items():
            gw = _f64(w)
            ok = np.abs(_f64(g_got[name]) - gw) <= noise * np.abs(gw)
            keep[name] = keep[name] & ok if name in keep else ok
    return keep


def update_errors(u_got: Dict[str, Any], u_want: Dict[str, Any],
                  keep: Dict[str, np.ndarray]) -> Dict[str, Tuple[float, int, int]]:
    """{name: (rel-L2, elements left out, elements)} of the update `u_got`
    against `u_want` (a parameter after a step minus before it), tensor by
    tensor over the elements `keep` keeps (``settled``): ||u_got - u_want||
    / ||u_want||, or ||u_got|| where the wanted update is 0 there."""
    out = {}
    for name, w in u_want.items():
        uw, ug, k = _f64(w), _f64(u_got[name]), keep[name]
        scale = float(np.linalg.norm(uw[k]))
        diff = float(np.linalg.norm((ug - uw)[k]))
        out[name] = (diff / scale if scale > 0 else diff, int(k.size - k.sum()), int(k.size))
    return out
