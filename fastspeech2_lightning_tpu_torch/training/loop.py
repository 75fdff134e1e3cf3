"""The trainer (counterpart of the JAX package's ``training/loop.py``
``Trainer.fit``, one device).

``Trainer(config).fit(max_steps, resume=True)`` reads ``stats.json`` under
``preprocessing.save_dir``, builds the model (flax's initial distributions,
variance bins from the stats), the bucketed loaders and the optimizer on the
resolved device, resumes from the newest ``checkpoints/step=N/`` (else from
``training.finetune_checkpoint``), and runs train steps until ``max_steps``,
``training.max_epochs``, early stopping or SIGTERM. Under
``<logger.save_dir>/<name>/<version>/`` every step appends a line to
``train_log.jsonl`` (the step, the epoch, the batch's [B, L, T], the step's
wall milliseconds, the milliseconds the loop waited for the batch before it,
and every loss) and every validation one to
``val_log.jsonl`` (the step, the epoch, the weighted mean of every loss, the
batches and the wall milliseconds). A non-finite loss raises when
``training.halt_on_non_finite`` is set.

Checkpoints (``training/checkpoint.py``) follow the JAX trainer's cadence
and order (``loop.py:687-719``): every ``ckpt_steps`` steps without a
metric, after every validation with ``validation/total_loss``, at the end of
every ``ckpt_epochs``-th epoch, and once at the end; a later save at the same
step replaces the earlier one, and ``save_top_k_ckpts`` by the metric (plus
the newest) are kept. Resume restores the parameters, BatchNorm statistics,
AdamW moments and count, EMA and epoch; the dropout generator of a step
depends on the global step only, so a resumed run draws what an
uninterrupted one would."""

from __future__ import annotations

import json
import math
import queue
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import MODEL_VERSION, parse_version, read_checkpoint
from ..dataset import BucketedLoader, load_datasets
from ..device import resolve_device
from ..models.fastspeech2 import FastSpeech2
from ..text import TextProcessor
from ..text.lookups import lookuptables_from_config
from ..type_definitions import Stats
from .checkpoint import (
    AsyncCheckpointWriter,
    latest_checkpoint,
    load_train_state,
    prune_checkpoints,
    read_meta,
    save_checkpoint,
    take_snapshot,
)
from .preemption import install_preemption_handler
from .state import AdamWNoam, init_like_flax
from .step import batch_to_device, eval_step, train_step

MONITOR = "validation/total_loss"


class TrainingDivergedError(RuntimeError):
    pass


class DevicePrefetcher:
    """Collates batches and copies them to the device on a thread, `size`
    batches ahead (``loop.py:128-215``); yields (host batch, device batch).
    On a card the copies leave pinned buffers on a side stream, and the
    consumer's stream waits for each batch's event. `size` 0 iterates
    synchronously. Closing the iterator (early stop, SIGTERM, an error)
    releases the thread."""

    _SENTINEL = object()

    def __init__(self, loader, device: torch.device, size: int = 2):
        self.loader = loader
        self.device = device
        self.size = size

    def _put(self, batch, stream):
        if stream is None:
            return batch, batch_to_device(batch, self.device), None
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            db = {k: v.pin_memory().to(self.device, non_blocking=True)
                  for k, v in batch_to_device(batch, "cpu").items()}
            event = torch.cuda.Event()
            event.record(stream)
        return batch, db, event

    def __iter__(self):
        if self.size <= 0:
            for batch in self.loader:
                yield batch, batch_to_device(batch, self.device)
            return
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.size)
        err: List[BaseException] = []
        stop = threading.Event()

        def produce():
            try:
                for batch in self.loader:
                    item = self._put(batch, stream)
                    # a bounded put that watches the stop flag: an abandoned
                    # consumer must not leave this thread blocked
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                while True:  # the sentinel must land even if the queue is full
                    try:
                        q.put(self._SENTINEL, timeout=0.5)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=produce, name="fs2t-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                batch, db, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in db.values():
                        v.record_stream(current)
                yield batch, db
            if err:
                raise err[0]
        finally:
            stop.set()  # an abandoned producer stops at its next put
            t.join()


def _set_bins(model, stats: Stats, config) -> None:
    """The variance adaptor's pitch and energy bins from the corpus stats."""
    vp = config.model.variance_predictors
    with torch.no_grad():
        for kind, st in (("pitch", stats.pitch), ("energy", stats.energy)):
            n_bins = getattr(vp, kind).n_bins
            getattr(model.variance_adaptor, f"{kind}_bins").copy_(torch.from_numpy(
                np.linspace(st.norm_min, st.norm_max, n_bins - 1, dtype=np.float32)))


class Trainer:
    def __init__(self, config, device=None, log_dir: Optional[Path] = None):
        self.config = config
        self.device = resolve_device(device)
        stats_path = Path(config.preprocessing.save_dir) / "stats.json"
        if not stats_path.exists():
            raise FileNotFoundError(
                f"{stats_path} not found: the variance adaptor needs the corpus stats "
                "(run preprocessing first)"
            )
        self.stats_dict = json.loads(stats_path.read_text(encoding="utf8"))
        self.stats = Stats.from_dict(self.stats_dict)
        self.lang2id, self.speaker2id = lookuptables_from_config(config)
        self.symbols = TextProcessor(config.text).symbols
        model = FastSpeech2(config, n_symbols=len(self.symbols),
                            n_speakers=max(len(self.speaker2id), 1),
                            n_languages=max(len(self.lang2id), 1))
        init_like_flax(model, config.training.seed)
        _set_bins(model, self.stats, config)
        self.model = model.to(self.device).train()
        self.optimizer = AdamWNoam(list(self.model.named_parameters()), config.training)
        self.ema = ([p.detach().clone() for p in self.optimizer.params]
                    if config.training.ema_decay > 0 else None)
        logger = config.training.logger
        self.log_dir = Path(log_dir or Path(logger.save_dir) / logger.name / logger.version)
        self.ckpt_dir = self.log_dir / "checkpoints"
        self._async = AsyncCheckpointWriter() if config.training.async_checkpoint else None
        self.save_ms: List[float] = []  # the caller's wall time of each save
        self.load_ms: Optional[float] = None
        self._epoch = 0

    @property
    def ckpt_path(self) -> Optional[Path]:
        """The newest ``step=N/`` directory."""
        return latest_checkpoint(self.ckpt_dir)

    def fit(self, max_steps: Optional[int] = None, resume: bool = True) -> List[dict]:
        """Train; returns the rows logged by this call (one per step)."""
        cfg = self.config
        tcfg = cfg.training
        max_steps = max_steps or tcfg.max_steps
        train_ds, val_ds = load_datasets(cfg, self.lang2id, self.speaker2id)
        self.loader = loader = BucketedLoader(
            train_ds, tcfg.batch_size, n_buckets=tcfg.bucket_count, seed=tcfg.seed,
            use_weighted_sampler=tcfg.use_weighted_sampler,
            max_mel_length=cfg.model.max_mel_length)
        self.val_loader = BucketedLoader(val_ds, min(tcfg.batch_size, max(len(val_ds), 1)),
                                         n_buckets=tcfg.bucket_count, seed=tcfg.seed,
                                         max_mel_length=cfg.model.max_mel_length)
        step = epoch = 0
        start = latest_checkpoint(self.ckpt_dir) if resume else None
        if start is None and tcfg.finetune_checkpoint:
            start = Path(tcfg.finetune_checkpoint)
        if start is not None:
            step, epoch = self.restore(start)
        val_interval = tcfg.val_check_interval or 500
        if isinstance(val_interval, float):
            # a float is a fraction of an epoch, an int a step count
            val_interval = max(1, round(val_interval * max(len(loader), 1)))
        self.log_dir.mkdir(parents=True, exist_ok=True)
        preempt = install_preemption_handler()
        try:
            return self._fit_loop(loader, max_steps, step, epoch, val_interval, preempt)
        finally:
            preempt["disarm"]()

    def _fit_loop(self, loader, max_steps, step, epoch, val_interval, preempt) -> List[dict]:
        cfg, tcfg = self.config, self.config.training
        es = tcfg.early_stopping
        best, stale, stop = float("inf"), 0, False
        prefetch = DevicePrefetcher(loader, self.device, tcfg.prefetch_batches)
        rows: List[dict] = []

        def crossed(interval, lo, hi):
            # a multiple of `interval` lies in the step window (lo, hi]
            return bool(interval) and hi // interval > lo // interval

        with open(self.log_dir / "train_log.jsonl", "a", encoding="utf8") as log:
            while step < max_steps and epoch < tcfg.max_epochs and not stop:
                self._epoch = epoch  # checkpoints store the live counter
                batches = iter(prefetch)
                t_free = time.perf_counter()
                try:
                    for batch, db in batches:
                        t0 = time.perf_counter()
                        losses = train_step(self.model, self.optimizer, cfg, db, step, epoch,
                                            self.ema)
                        host = {k: float(v) for k, v in losses.items()}  # waits for the step
                        prev, step = step, step + 1
                        row = {"step": step, "epoch": epoch,
                               "shape": [*map(int, batch["text"].shape),
                                         int(batch["mel"].shape[1])],
                               "ms": (time.perf_counter() - t0) * 1e3,
                               "wait_ms": (t0 - t_free) * 1e3, **host}
                        log.write(json.dumps(row) + "\n")
                        log.flush()
                        rows.append(row)
                        if tcfg.halt_on_non_finite and not all(map(math.isfinite, host.values())):
                            raise TrainingDivergedError(
                                f"non-finite training loss at step {step}: {host}")
                        if step == 1 or step % 50 == 0:
                            print(f"step {step} epoch {epoch} total={host['total']:.4f} "
                                  f"spec={host.get('spec', 0.0):.4f} {row['ms']:.1f} ms",
                                  flush=True)
                        if preempt["flag"]:
                            print(f"received signal {preempt['signum']}: checkpointing at "
                                  f"step {step} and exiting cleanly", flush=True)
                            stop = True
                            break
                        if tcfg.ckpt_steps and crossed(tcfg.ckpt_steps, prev, step):
                            self._save(step)
                        if crossed(val_interval, prev, step) or step >= max_steps:
                            total = self.validate(step, epoch).get("total")
                            self._save(step, metrics={MONITOR: total})
                            if es.metric != "none":
                                current = float("inf") if total is None else total
                                if current < best - 1e-6:
                                    best, stale = current, 0
                                else:
                                    stale += 1
                                    if stale >= es.patience:
                                        print(f"early stopping: {MONITOR} stale for {stale} "
                                              "validations", flush=True)
                                        stop = True
                                        break
                        if step >= max_steps:
                            break
                        t_free = time.perf_counter()
                finally:
                    batches.close()
                epoch += 1
                self._epoch = epoch
                if tcfg.ckpt_epochs and epoch % tcfg.ckpt_epochs == 0:
                    self._save(step)
        self._save(step)  # the final checkpoint; a pending async save is joined first
        if self._async is not None:
            self._async.wait()
        return rows

    def validate(self, step: int, epoch: int) -> dict:
        """Weighted mean of each loss over the validation batches (each
        batch's mean weighted by its sample_weight sum, so filler rows count
        for nothing); appends a row to ``val_log.jsonl``."""
        t0 = time.perf_counter()
        sums: dict = {}
        total_w, n = 0.0, 0
        for batch in self.val_loader:
            losses, _ = eval_step(self.model, self.config,
                                  batch_to_device(batch, self.device), epoch)
            w = float(np.sum(batch["sample_weight"]))
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v) * w
            total_w += w
            n += 1
        means = {k: v / max(total_w, 1e-9) for k, v in sums.items()}
        row = {"step": step, "epoch": epoch, "batches": n,
               "ms": (time.perf_counter() - t0) * 1e3, **means}
        with open(self.log_dir / "val_log.jsonl", "a", encoding="utf8") as f:
            f.write(json.dumps(row) + "\n")
        return means

    def _save(self, step: int, metrics: Optional[dict] = None) -> None:
        t0 = time.perf_counter()
        tcfg = self.config.training
        args = (self.config.to_dict(), self.stats_dict, self.lang2id, self.speaker2id,
                self.symbols)
        if self._async is not None:
            self._async.save(self.ckpt_dir, self.model, self.optimizer, self.ema, step,
                             self._epoch, *args, metrics=metrics,
                             keep_top_k=tcfg.save_top_k_ckpts, monitor=MONITOR)
        else:
            snap = take_snapshot(self.model, self.optimizer, self.ema, step, self._epoch)
            save_checkpoint(self.ckpt_dir, snap, *args, metrics=metrics)
            prune_checkpoints(self.ckpt_dir, tcfg.save_top_k_ckpts, MONITOR)
        self.save_ms.append((time.perf_counter() - t0) * 1e3)

    def restore(self, path: Path) -> Tuple[int, int]:
        """Load a ``step=N/`` directory (weights, AdamW state, EMA, epoch) or
        a reference ``.ckpt`` (weights only: the optimizer starts fresh at
        its global_step); returns (step, epoch). The variance bins stay the
        ones of this run's stats. A checkpoint from before version 1.2 whose
        symbols differ has its embedding rows remapped and starts a fresh
        optimizer, as the JAX trainer does."""
        t0 = time.perf_counter()
        path = Path(path)
        meta = read_meta(path) if path.is_dir() else None
        ckpt, _ = read_checkpoint(path / "model.ckpt" if meta else path, self.symbols)
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        _set_bins(self.model, self.stats, self.config)
        step, epoch, saved_ema = int(ckpt.get("global_step", 0)), 0, None
        if meta is not None:
            step, epoch = int(meta["global_step"]), int(meta.get("epoch") or 0)
            saved = meta.get("model_info", {}).get("version", MODEL_VERSION)
            migrated = (parse_version(saved) < parse_version(MODEL_VERSION)
                        and meta.get("symbols", []) != self.symbols)
            if not migrated:
                ts = load_train_state(path)
                self.optimizer.load_state(ts["mu"], ts["nu"], ts["count"])
                saved_ema = ts.get("ema")
        if self.ema is not None:
            with torch.no_grad():
                for name, e, p in zip(self.optimizer.names, self.ema, self.optimizer.params):
                    # EMA switched on since the save starts from the parameters
                    e.copy_(saved_ema[name] if saved_ema is not None else p)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_ms = (time.perf_counter() - t0) * 1e3
        print(f"resumed from {path} at step {step}, epoch {epoch} "
              f"({'weights only' if meta is None else 'full state'})", flush=True)
        return step, epoch
