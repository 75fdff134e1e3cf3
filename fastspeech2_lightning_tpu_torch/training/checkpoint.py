"""The trainer's checkpoints, without orbax (counterpart of the JAX package's
``training/checkpoint.py``).

A checkpoint is a directory ``step=N/`` under the run's ``checkpoints/``:

- ``model.ckpt``: the model in the reference Lightning layout
  (``write_checkpoint``), which the port's ``Synthesizer`` and ``serve`` and
  the JAX package's ``.ckpt`` loader read;
- ``train_state.pt``: the AdamW moments ``mu`` and ``nu`` and the update
  ``count``, and the EMA weights (``ema``, None without ``ema_decay``),
  keyed by parameter name;
- ``meta.json``: the keys of the JAX package's meta (``:114-135``), with
  ``optimizer_format`` "fused" for the flat ZeRO-1 optimizer and "per_leaf"
  otherwise (the moments are stored per parameter either way).

A run over several ranks saves the full reference layout: the snapshot
gathers the model-split parameters, EMA and moments and the ZeRO-1 slices
(every rank takes part), and rank 0 writes (the trainer's ``_save``), so a
checkpoint reads the same whatever world size wrote it.

Everything is written into ``step=N.tmp`` and renamed to ``step=N`` after
``meta.json`` is on disk, so a save killed part way leaves nothing that
``latest_checkpoint`` picks. ``AsyncCheckpointWriter`` does the copy to the
host and the writing on a thread while training goes on.
``average_checkpoints`` writes the uniform average of several ``step=N/``
directories as one more (the ``average-checkpoints`` command)."""

from __future__ import annotations

import json
import shutil
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint import (
    EMBEDDING,
    MODEL_INFO,
    CheckpointError,
    read_checkpoint,
    write_checkpoint,
)
from ..models.fastspeech2 import FastSpeech2
from ..parallel.mesh import gather_state_dict
from .state import ZeroAdamWNoam

Tensors = Dict[str, torch.Tensor]


@dataclass
class TrainSnapshot:
    """What a checkpoint stores of a run: the model's state_dict, the
    optimizer's moments and count, the EMA weights, and where the run is."""

    state_dict: Tensors
    mu: Tensors
    nu: Tensors
    count: int
    ema: Optional[Tensors]
    step: int
    epoch: int
    optimizer_format: str = "per_leaf"


class _Packed:
    """The tensors of a dict copied into one flat buffer per dtype: one
    concatenation (and one device-to-host copy) instead of one copy a
    tensor. ``unpack`` gives them back, by name, as views of the buffers."""

    def __init__(self, tensors: Tensors):
        groups: Dict[torch.dtype, List[str]] = {}
        for k, t in tensors.items():
            groups.setdefault(t.dtype, []).append(k)
        self.names = list(tensors)
        self.layout = [[(k, tensors[k].shape) for k in keys] for keys in groups.values()]
        self.flats = [torch.cat([tensors[k].detach().reshape(-1) for k in keys])
                      for keys in groups.values()]

    def unpack(self) -> Tensors:
        out = {}
        for flat, layout in zip(self.flats, self.layout):
            for piece, (k, shape) in zip(flat.split([s.numel() for _, s in layout]), layout):
                out[k] = piece.view(shape)
        return {k: out[k] for k in self.names}


def _pack_run(model, optimizer, ema: Optional[List[torch.Tensor]]) -> Dict[str, _Packed]:
    """Copies of the run's tensors on their device in the full reference
    layout, queued on the current stream (so ahead of the next step's
    in-place updates); collective where the run is split over ranks."""
    names = optimizer.names
    plan = getattr(model, "parallel_plan", None) or {}
    mu, nu = optimizer.moments()
    parts = {"state_dict": gather_state_dict(model.state_dict(), plan),
             "mu": mu, "nu": nu}
    if ema is not None:
        parts["ema"] = gather_state_dict(dict(zip(names, ema)), plan)
    return {k: _Packed(v) for k, v in parts.items()}


def _optimizer_format(optimizer) -> str:
    return "fused" if isinstance(optimizer, ZeroAdamWNoam) else "per_leaf"


def _snapshot(packs: Dict[str, _Packed], count: int, step: int, epoch: int,
              optimizer_format: str) -> TrainSnapshot:
    return TrainSnapshot(
        state_dict=packs["state_dict"].unpack(), mu=packs["mu"].unpack(),
        nu=packs["nu"].unpack(), count=int(count),
        ema=packs["ema"].unpack() if "ema" in packs else None, step=int(step), epoch=int(epoch),
        optimizer_format=optimizer_format,
    )


def take_snapshot(model, optimizer, ema: Optional[List[torch.Tensor]], step: int,
                  epoch: int) -> TrainSnapshot:
    """Host copies of the run's tensors in the full reference layout (every
    rank of a split run calls it)."""
    packs = _pack_run(model, optimizer, ema)
    for pack in packs.values():
        pack.flats = [f.cpu() for f in pack.flats]
    return _snapshot(packs, optimizer.count, step, epoch, _optimizer_format(optimizer))


def _publish(path: Path, model_ckpt: Callable[[Path], object], train_state: dict,
             meta: dict) -> Path:
    """Write a checkpoint directory: `model_ckpt(file)` writes model.ckpt,
    then train_state.pt and meta.json, all into ``<path>.tmp``, renamed to
    `path` (replacing one that exists) once meta.json is on disk."""
    tmp = path.with_name(f"{path.name}.tmp")
    for p in (path, tmp):
        if p.exists():
            shutil.rmtree(p)
    tmp.mkdir(parents=True)
    model_ckpt(tmp / "model.ckpt")
    torch.save(train_state, tmp / "train_state.pt")
    with open(tmp / "meta.json", "w", encoding="utf8") as f:
        json.dump(meta, f, indent=2)
    tmp.rename(path)
    return path


def save_checkpoint(ckpt_dir: Path, snap: TrainSnapshot, config: dict, stats: Optional[dict],
                    lang2id: dict, speaker2id: dict, symbols: List[str],
                    metrics: Optional[dict] = None) -> Path:
    """Write ``step=N/`` (N = snap.step) under `ckpt_dir`, replacing one that
    exists; `snap` holds host tensors."""
    array_keys = ["opt_state", "params"] + (["ema_params"] if snap.ema is not None else [])
    meta = {
        "model_info": dict(MODEL_INFO),
        "global_step": snap.step,
        "config": config,
        "stats": stats,
        "lang2id": lang2id,
        "speaker2id": speaker2id,
        "symbols": list(symbols),
        "metrics": metrics or {},
        "epoch": snap.epoch,
        "array_keys": sorted(array_keys),
        "optimizer_format": snap.optimizer_format,
    }
    return _publish(
        Path(ckpt_dir) / f"step={snap.step}",
        lambda file: write_checkpoint(file, snap.state_dict, config, stats, lang2id,
                                      speaker2id, global_step=snap.step),
        {"mu": snap.mu, "nu": snap.nu, "count": snap.count, "ema": snap.ema}, meta)


def average_checkpoints(ckpt_paths: List[Path], out_path: Path, use_ema: bool = False) -> Path:
    """Uniform parameter averaging over ``step=N/`` directories (the JAX
    package's ``training/checkpoint.py:324-389``): the model's parameters,
    or with `use_ema` the EMA weights of ``train_state.pt``, summed in
    float64 and divided before the cast back to each tensor's dtype. The
    parameters are told from the buffers by the ``named_parameters()`` of
    the model the newest checkpoint's config builds: BatchNorm statistics,
    the variance bins and the other buffers come from the newest checkpoint,
    as do its AdamW moments and count (the optimizer state is not averaged;
    the EMA is dropped) and its meta.json, with ``metrics`` emptied and
    ``averaged_from`` listing the inputs. Written to `out_path` as
    ``save_checkpoint`` publishes a step directory."""
    if not ckpt_paths:
        raise CheckpointError("average_checkpoints: no checkpoints given")
    ckpt_paths = [Path(p) for p in ckpt_paths]
    loaded = []
    for p in ckpt_paths:
        state = load_train_state(p)
        if use_ema and state.get("ema") is None:
            raise CheckpointError(f"{p} has no ema_params (trained without ema_decay)")
        ckpt, config = read_checkpoint(p / "model.ckpt")
        loaded.append((read_meta(p), ckpt, config, state))
    meta, ckpt, config, state = max(loaded, key=lambda m: m[0]["global_step"])
    sd = ckpt["state_dict"]
    with torch.device("meta"):
        model = FastSpeech2(
            config, n_symbols=sd[EMBEDDING].shape[0],
            n_speakers=(sd["speaker_embedding.weight"].shape[0]
                        if "speaker_embedding.weight" in sd else 1),
            n_languages=(sd["language_embedding.weight"].shape[0]
                         if "language_embedding.weight" in sd else 1))
    names = [name for name, _ in model.named_parameters()]
    trees = [s["ema"] if use_ema else c["state_dict"] for _, c, _, s in loaded]
    for p, tree in zip(ckpt_paths, trees):
        if any(name not in tree or tree[name].shape != trees[0][name].shape for name in names):
            raise CheckpointError(f"{p} has a different parameter structure; cannot average")
    averaged = dict(sd)
    for name in names:
        leaves = [tree[name] for tree in trees]
        if leaves[0].is_floating_point():
            total = sum(leaf.to(torch.float64) for leaf in leaves)
            averaged[name] = (total / len(leaves)).to(leaves[0].dtype)
        else:
            averaged[name] = leaves[0]
    out_ckpt = {**ckpt, "state_dict": averaged}
    out_meta = {**meta, "metrics": {}, "averaged_from": [str(p) for p in ckpt_paths],
                "array_keys": ["opt_state", "params"]}
    train_state = {"mu": state["mu"], "nu": state["nu"], "count": state["count"], "ema": None}
    return _publish(Path(out_path), lambda file: torch.save(out_ckpt, file), train_state,
                    out_meta)


def load_train_state(path: Path) -> dict:
    """``train_state.pt`` of a ``step=N/`` directory: mu, nu, count, ema."""
    return torch.load(Path(path) / "train_state.pt", map_location="cpu", weights_only=True)


def read_meta(path: Path) -> dict:
    return json.loads((Path(path) / "meta.json").read_text(encoding="utf8"))


class AsyncCheckpointWriter:
    """Checkpoint I/O beside training (``training.async_checkpoint``).

    ``save`` copies the run's tensors on their device (queued on the current
    stream before the next step updates the parameters in place) and records
    an event; a thread waits for it on a stream of its own, copies to pinned
    host memory there, and writes and prunes. At most one save is in
    flight: ``save`` first joins the previous one. ``wait`` joins and
    re-raises a failure of the thread as CheckpointError."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save(self, ckpt_dir: Path, model, optimizer, ema, step: int, epoch: int,
             config: dict, stats, lang2id, speaker2id, symbols,
             metrics: Optional[dict] = None, keep_top_k: Optional[int] = None,
             monitor: Optional[str] = None) -> None:
        self.wait()
        packs = _pack_run(model, optimizer, ema)
        count, fmt = int(optimizer.count), _optimizer_format(optimizer)
        device = packs["state_dict"].flats[0].device
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))

        def work():
            try:
                if ready is not None:
                    _to_host(packs, ready, device)
                save_checkpoint(ckpt_dir, _snapshot(packs, count, step, epoch, fmt), config, stats,
                                lang2id, speaker2id, symbols, metrics=metrics)
                if keep_top_k is not None and monitor is not None:
                    prune_checkpoints(ckpt_dir, keep_top_k, monitor)
            except BaseException as exc:  # surfaced on the next wait()
                self._exc = exc

        self._thread = threading.Thread(target=work, name="fs2t-async-ckpt", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise CheckpointError(f"async checkpoint save failed: {exc}") from exc


def _to_host(packs: Dict[str, _Packed], ready, device) -> None:
    """Move the buffers into pinned host memory, copied on a side stream once
    `ready` has fired; the device buffers live until the copies are done."""
    stream = torch.cuda.Stream(device)
    on_device = []
    with torch.cuda.device(device), torch.cuda.stream(stream):
        stream.wait_event(ready)
        for pack in packs.values():
            on_device += pack.flats
            pack.flats = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True).copy_(
                f, non_blocking=True) for f in pack.flats]
    stream.synchronize()
    del on_device


def prune_checkpoints(ckpt_dir: Path, keep_top_k: int, monitor: str) -> None:
    """Keep the k best checkpoints by the monitored metric (lower is better),
    always keeping the latest (for resume)."""
    ckpt_dir = Path(ckpt_dir)
    entries = []
    for p in ckpt_dir.glob("step=*"):
        try:
            meta = json.loads((p / "meta.json").read_text())
        except Exception:
            continue
        entries.append((p, meta.get("metrics", {}).get(monitor), meta["global_step"]))
    if len(entries) <= keep_top_k:
        return
    latest = max(entries, key=lambda e: e[2])[0]
    scored = [e for e in entries if e[1] is not None]
    scored.sort(key=lambda e: e[1])
    keep = {p for p, _, _ in scored[:keep_top_k]} | {latest}
    for p, _, _ in entries:
        if p not in keep:
            shutil.rmtree(p)


def latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    """The newest published ``step=N`` directory; ``step=N.tmp`` and
    directories without ``meta.json`` are skipped."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.glob("step=*"):
        try:
            n = int(p.name.split("=")[1])
        except ValueError:  # step=N.tmp in-progress dirs
            continue
        if not (p / "meta.json").exists():
            continue
        steps.append((n, p))
    return max(steps)[1] if steps else None
