"""One process driving one model replica per device (the serving
counterpart of the JAX package's ``make_mesh(model_parallel=1)`` and
``shard_batch``, ``parallel/mesh.py:24-35, :135``).

The JAX package serves from one process over its local chips: the weights
are replicated, the rows of a request batch are split over the mesh's data
axis, and no collective runs in the forward, as rows are independent. The
port does the same with explicit replicas:

- ``replica_devices`` gives the device list: ``data_parallel=N`` means
  ``cuda:0 .. cuda:N-1`` (N CPU replicas with ``device="cpu"``), and a list
  names the devices itself (two replicas may share one card). Asking for
  more cards than ``torch.cuda.device_count()`` raises, where JAX's
  ``make_mesh`` takes the first ones there are.
- ``make_replicas`` gives one model a device: the model itself on the first
  device, ``copy.deepcopy(model).to(dev)`` on the others, in eval mode, so
  the replicas share nothing mutable.
- A batch's rows are padded to a multiple of N with copies of row 0
  (``pad_rows``, as JAX pads, ``synthesis/api.py:261-268``), split into N
  contiguous blocks (``split_rows``) and put back together in order
  (``concat_rows``); the caller slices the fill rows off.
- ``Replicas.map`` runs a function once a replica, each on its replica's
  own worker thread, under ``torch.cuda.device(dev)`` and on a stream of its
  own, with the caller's autograd mode: the host issues the replicas' work
  side by side, which one thread issuing them in turn would serialize. With
  one replica it runs inline on the caller's thread and stream.

A worker waits for the caller's current stream on its device before it
starts (inputs the caller queued there are ready) and synchronizes its own
stream before it returns, so the caller may read what it returns on any
stream; a tensor a worker returns that the caller copies asynchronously
goes through ``to_caller``, which records the caller's stream on it."""

from __future__ import annotations

import concurrent.futures
import copy
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

Rows = Union[np.ndarray, torch.Tensor, list]


def replica_devices(devices: Optional[Sequence] = None, data_parallel: Optional[int] = None,
                    device=None) -> List[torch.device]:
    """The replicas' devices: `devices` as given, else `data_parallel` (1
    when None) devices from `device`: that many CPU replicas for "cpu",
    else cards ``cuda:k .. cuda:k+N-1`` from `device`'s index k (0 when it
    names none). A card past ``torch.cuda.device_count()`` raises a
    ValueError naming both numbers."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("devices names no device")
    else:
        n = 1 if data_parallel is None else int(data_parallel)
        if n < 1:
            raise ValueError(f"data_parallel must be at least 1, got {n}")
        base = torch.device("cuda" if device is None else device)
        if base.type == "cpu":
            return [base] * n
        if base.type != "cuda":
            raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
        if n == 1 and base.index is None:
            from ..device import resolve_device

            return [resolve_device(base)]
        start = base.index or 0
        out = [torch.device("cuda", start + i) for i in range(n)]
    cards = [d for d in out if d.type == "cuda"]
    if any(d.type not in ("cpu", "cuda") for d in out):
        raise ValueError(f"unsupported device in {out}; use 'cuda' or 'cpu'")
    if cards:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; this entry point runs on the GPU "
                               "unless called with device='cpu'")
        count = torch.cuda.device_count()
        need = max((d.index or 0) for d in cards) + 1
        if need > count:
            raise ValueError(f"{len(out)} replicas need {need} CUDA devices "
                             f"({', '.join(map(str, out))}), but torch.cuda.device_count() "
                             f"is {count}")
        out = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in out]
    return out


def make_replicas(model: torch.nn.Module, devices: Sequence[torch.device]
                  ) -> List[torch.nn.Module]:
    """One model a device, in eval mode: `model` itself on the first device
    (moved there), a deep copy on each other one."""
    out = []
    for i, dev in enumerate(devices):
        m = model.to(dev) if i == 0 else copy.deepcopy(model).to(dev)
        out.append(m.eval())
    return out


def fill_count(n_rows: int, n_replicas: int) -> int:
    """Rows of fill that make `n_rows` a multiple of `n_replicas`."""
    return -n_rows % n_replicas


def pad_rows(x: Rows, n_fill: int) -> Rows:
    """`x` with `n_fill` copies of its row 0 appended."""
    if n_fill == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:1].expand(n_fill, *x.shape[1:])])
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.repeat(x[:1], n_fill, axis=0)])
    return list(x) + [x[0]] * n_fill


def split_rows(x: Rows, n: int) -> List[Rows]:
    """N contiguous blocks of `x`'s rows, which N must divide."""
    rows = len(x)
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} replicas")
    per = rows // n
    return [x[i * per:(i + 1) * per] for i in range(n)]


def concat_rows(parts: Sequence) -> Union[np.ndarray, torch.Tensor]:
    """The blocks (arrays or tensors) put back together in order."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts))
    return np.concatenate(parts)


def split_batch(batch: dict, n: int, n_rows: int) -> List[dict]:
    """N dicts of contiguous row blocks of `batch`: every value with a
    leading axis of `n_rows` (arrays, tensors, lists) is split, any other
    value (None, a scalar) goes to every block as it is."""
    out: List[dict] = [{} for _ in range(n)]
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list)) and getattr(v, "ndim", 1) > 0 \
                and len(v) == n_rows:
            for block, part in zip(out, split_rows(v, n)):
                block[k] = part
        else:
            for block in out:
                block[k] = v
    return out


def to_caller(t: torch.Tensor, device) -> torch.Tensor:
    """A worker's tensor on the caller's `device`: the caller's current
    stream is recorded on it first, so its memory is not handed to the
    worker's stream again while the copy still reads it."""
    if t.device.type == "cuda":
        t.record_stream(torch.cuda.current_stream(t.device))
    return t.to(device)


class Replicas:
    """One worker thread a device; ``map`` runs a function once a replica
    on them (inline for a single replica)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._streams: List[Optional[torch.cuda.Stream]] = [None] * len(self.devices)
        self._pools = None
        if len(self.devices) > 1:
            self._pools = [
                concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix=f"fs2t-replica{i}")
                for i in range(len(self.devices))
            ]

    def __len__(self) -> int:
        return len(self.devices)

    def map(self, fn: Callable, *per_replica: Sequence) -> List[Any]:
        """[fn(i, *(a[i] for a in per_replica)) for each replica i], in
        order. Every worker runs to its end before the first error (if any)
        is raised here."""
        if self._pools is None:
            return [fn(0, *(a[0] for a in per_replica))]
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
        waits = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                 for d in self.devices]
        futures = [pool.submit(self._run, i, fn, grad, inference, waits[i],
                               [a[i] for a in per_replica])
                   for i, pool in enumerate(self._pools)]
        concurrent.futures.wait(futures)
        return [f.result() for f in futures]

    def _run(self, i: int, fn: Callable, grad: bool, inference: bool, wait, args: list):
        dev = self.devices[i]
        with torch.set_grad_enabled(grad), torch.inference_mode(inference):
            if dev.type != "cuda":
                return fn(i, *args)
            stream = self._streams[i]
            if stream is None:
                stream = self._streams[i] = torch.cuda.Stream(device=dev)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_stream(wait)
                out = fn(i, *args)
                stream.synchronize()
            return out
