"""The trainer (counterpart of the JAX package's ``training/loop.py``
``Trainer.fit``).

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

``training.steps_per_call`` k > 1 groups runs of k consecutive same-shape
batches into one call (``group_steps``, the JAX trainer's ``_group_steps``,
``loop.py:64-126``): on a card k replays of the captured train step
(``step.TrainStepGraph``), on the CPU k eager steps, with one fetch of the
losses a call; a batch alone runs the eager step. A tail group is split so
the run stops at exactly ``max_steps``; the log keeps one row a step (its
``call_steps`` the size of its call, ``ms`` and ``wait_ms`` the call's
share); the non-finite guard, preemption, validation, checkpoints and early
stopping act at call boundaries, their step windows quantized up, as in
JAX (``loop.py:620-690``). Across processes it runs one step a call.

The same directory holds a TensorBoard event file (``utils/tensorboard.py``)
with the JAX trainer's tags (``loop.py:372-383, :677, :692, :724-891``):
``training/<k>_loss`` and ``training/grad_norm`` at step 1 and every 50th
step, ``validation/<k>_loss`` after each validation, and the first
validation batch's media: ``attention/<basename>`` (soft and hard
alignment), ``pred/spec_<basename>`` (GT and predicted mel with pitch and
energy), ``pred/wav_<basename>`` through ``training.vocoder_path``, and at
step 0 ``gt/wav_<basename>`` and ``copy-synthesis/wav_<basename>``.

Checkpoints (``training/checkpoint.py``) follow the JAX trainer's cadence
and order (``loop.py:687-719``): every ``ckpt_steps`` steps without a
metric, after every validation with ``validation/total_loss``, at the end of
every ``ckpt_epochs``-th epoch, and once at the end; a later save at the same
step replaces the earlier one, and ``save_top_k_ckpts`` by the metric (plus
the newest) are kept. Resume restores the parameters, BatchNorm statistics,
AdamW moments and count, EMA and epoch; the dropout generator of a step
depends on the global step only, so a resumed run draws what an
uninterrupted one would.

Across processes (``train --distributed``; ``parallel/``) every rank runs
this trainer on its device. ``Trainer(..., model_parallel=N)`` lays the
world out as (world / N data ranks) x (N model ranks); the model is split
over the model group (``parallel.shard_model``), the loaders collate each
data rank's rows of the same global batches, and each step computes the
one-process step on the global batch (``step.py``). Only rank 0 writes:
``train_log.jsonl``, ``val_log.jsonl``, the event file with its media, the
checkpoints (gathered into the full reference layout by every rank, written
synchronously between two barriers, as the JAX trainer does,
``loop.py:332-345``) and the prune. A validation weights each batch by its
global real rows (``n_real_global``) and reports the global losses, so early
stopping decides alike on every rank, and the preemption flag is reduced
(MAX) once a step, so all ranks leave at the same step after a SIGTERM."""

from __future__ import annotations

import contextlib
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
from ..exceptions import TrainingDivergedError
from ..models.fastspeech2 import FastSpeech2
from ..parallel.mesh import (
    all_reduce,
    barrier,
    make_layout,
    set_layout,
    shard_model,
    shard_state_dict,
)
from ..parallel.mesh import layout as parallel_layout
from ..text import TextProcessor
from ..text.lookups import lookuptables_from_config
from ..type_definitions import Stats
from ..utils import plotting
from ..utils.tensorboard import SummaryWriter
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
from .state import init_like_flax, make_optimizer
from .step import DEVICE_KEYS, TrainStepGraph, batch_to_device, eval_step, train_step

MONITOR = "validation/total_loss"
LOG_EVERY = 50  # training scalars at step 1 and every LOG_EVERY-th step, as in JAX
UNSHARDED_ONLY = "steps_per_call > 1 requires an unsharded run; using 1"


def group_steps(loader, k: int):
    """Yield (n, host batch): runs of k consecutive batches of one
    signature (every key's shape and dtype, or type) with their device
    arrays stacked on a new leading axis, and the batches that form no run
    alone with n = 1 (JAX ``_group_steps``, ``loop.py:64-113``). A change of
    signature flushes the pending run."""
    pend: list = []
    sig = None

    def _sig(b):
        return tuple(sorted((key, tuple(getattr(v, "shape", ())),
                             str(getattr(v, "dtype", type(v)))) for key, v in b.items()))

    def _flush():
        nonlocal pend
        out = []
        while pend:
            if len(pend) >= k:
                take, pend = pend[:k], pend[k:]
                keys = [key for key in DEVICE_KEYS if hasattr(take[0].get(key), "shape")]
                out.append((k, {key: np.stack([b[key] for b in take]) for key in keys}))
            else:
                out.append((1, pend.pop(0)))
        return out

    for b in loader:
        s = _sig(b)
        if sig is not None and s != sig:
            yield from _flush()
        sig = s
        pend.append(b)
        if len(pend) == k:
            yield from _flush()
            sig = None
    yield from _flush()


class GroupedLoader:
    """Re-iterable view of ``group_steps`` (the prefetcher restarts its
    loader every epoch)."""

    def __init__(self, loader, k: int):
        self.loader = loader
        self.k = k

    def __iter__(self):
        return group_steps(self.loader, self.k)


def steps_per_call(k: int, lay, is_main: bool) -> int:
    """`k`, or 1 under a layout of more than one process, with the JAX
    trainer's notice (``loop.py:551-560``)."""
    if k > 1 and lay.distributed:
        if is_main:
            print(UNSHARDED_ONLY, flush=True)
        return 1
    return k


def _row(batch: dict, i: int) -> dict:
    """Batch i of a stacked batch."""
    return {k: v[i] for k, v in batch.items()}


class DevicePrefetcher:
    """Collates batches and copies them to the device on a thread, `size`
    batches ahead (``loop.py:128-215``); yields (host batch, device batch),
    or (n, host batch, device batch) when `grouped` (the loader yields
    ``group_steps``' (n, batch), n passed through). On a card the copies
    leave pinned buffers on a side stream, and the consumer's stream waits
    for each batch's event. `size` 0 iterates synchronously. Closing the
    iterator (early stop, SIGTERM, an error) releases the thread."""

    _SENTINEL = object()

    def __init__(self, loader, device: torch.device, size: int = 2, grouped: bool = False):
        self.loader = loader
        self.device = device
        self.size = size
        self.grouped = grouped

    def _split(self, item):
        return item if self.grouped else (1, item)

    def _out(self, n, batch, db):
        return (n, batch, db) if self.grouped else (batch, db)

    def _put(self, item, stream):
        n, batch = self._split(item)
        if stream is None:
            return n, batch, batch_to_device(batch, self.device), None
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            db = {k: v.pin_memory().to(self.device, non_blocking=True)
                  for k, v in batch_to_device(batch, "cpu").items()}
            event = torch.cuda.Event()
            event.record(stream)
        return n, batch, db, event

    def __iter__(self):
        if self.size <= 0:
            for item in self.loader:
                n, batch = self._split(item)
                yield self._out(n, batch, batch_to_device(batch, self.device))
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
                n, batch, db, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in db.values():
                        v.record_stream(current)
                yield self._out(n, batch, db)
            if err:
                raise err[0]
        finally:
            stop.set()  # an abandoned producer stops at its next put
            t.join()


def set_variance_bins(model, stats: Stats, config) -> None:
    """The variance adaptor's pitch and energy bins from the corpus stats."""
    vp = config.model.variance_predictors
    with torch.no_grad():
        for kind, st in (("pitch", stats.pitch), ("energy", stats.energy)):
            n_bins = getattr(vp, kind).n_bins
            getattr(model.variance_adaptor, f"{kind}_bins").copy_(torch.from_numpy(
                np.linspace(st.norm_min, st.norm_max, n_bins - 1, dtype=np.float32)))


class Trainer:
    @property
    def layout(self):
        """The process layout this trainer installed (``parallel.layout()``)."""
        return parallel_layout()

    def __init__(self, config, device=None, log_dir: Optional[Path] = None,
                 model_parallel: int = 1):
        self.config = config
        # install the process layout (parallel/mesh.py), which every layer,
        # loss, step and optimizer reads; trivial without a process group
        lay = make_layout(model_parallel)
        set_layout(lay)
        self.is_main = lay.is_main
        bs = config.training.batch_size
        if bs % lay.data_size:
            raise ValueError(f"training.batch_size={bs} must divide evenly over "
                             f"{lay.data_size} data ranks")
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
        set_variance_bins(model, self.stats, config)
        self.model = model.to(self.device).train()
        shard_model(self.model)  # this model rank's slices (none in one process)
        self.optimizer = make_optimizer(self.model, config.training)
        self.ema = ([p.detach().clone() for p in self.optimizer.params]
                    if config.training.ema_decay > 0 else None)
        logger = config.training.logger
        self.log_dir = Path(log_dir or Path(logger.save_dir) / logger.name / logger.version)
        self.ckpt_dir = self.log_dir / "checkpoints"
        # saves across processes are collective and synchronous, as in JAX
        self._async = (AsyncCheckpointWriter()
                       if config.training.async_checkpoint and not lay.distributed else None)
        self.save_ms: List[float] = []  # the caller's wall time of each save
        self.load_ms: Optional[float] = None
        self._epoch = 0
        self.loader = self.val_loader = None  # built by fit, or by validate alone
        self._graph: Optional[TrainStepGraph] = None  # steps_per_call's, on a card
        self._writer: Optional[SummaryWriter] = None
        self._media_vocoder = None  # training.vocoder_path's, loaded at its first use

    @property
    def writer(self) -> SummaryWriter:
        """The event file writer, opened at its first use; ``close`` ends it."""
        if self._writer is None:
            self._writer = SummaryWriter(self.log_dir)
        return self._writer

    def close(self) -> None:
        """Close the event file (``fit`` does so on its way out)."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def _log(self, tag: str, value: float, step: int) -> None:
        if self.is_main:
            self.writer.add_scalar(tag, value, step)

    @property
    def ckpt_path(self) -> Optional[Path]:
        """The newest ``step=N/`` directory."""
        return latest_checkpoint(self.ckpt_dir)

    def fit(self, max_steps: Optional[int] = None, resume: bool = True) -> List[dict]:
        """Train; returns the rows logged by this call (one per step)."""
        tcfg = self.config.training
        max_steps = max_steps or tcfg.max_steps
        loader = self._build_loaders()
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
        if self.is_main:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        preempt = install_preemption_handler()
        try:
            return self._fit_loop(loader, max_steps, step, epoch, val_interval, preempt)
        finally:
            preempt["disarm"]()
            self.close()

    def _build_loaders(self) -> BucketedLoader:
        """The training and validation loaders; returns the training one."""
        cfg, tcfg = self.config, self.config.training
        train_ds, val_ds = load_datasets(cfg, self.lang2id, self.speaker2id)
        shard = (self.layout.data_rank, self.layout.data_size)
        self.loader = BucketedLoader(
            train_ds, tcfg.batch_size, n_buckets=tcfg.bucket_count, seed=tcfg.seed,
            use_weighted_sampler=tcfg.use_weighted_sampler,
            max_mel_length=cfg.model.max_mel_length, shard=shard)
        # across processes the global validation batch must divide over the
        # data ranks too: the training batch size, with zero-weight fill
        # (JAX loop.py:400-406)
        val_bs = (tcfg.batch_size if self.layout.distributed
                  else min(tcfg.batch_size, max(len(val_ds), 1)))
        self.val_loader = BucketedLoader(val_ds, val_bs, n_buckets=tcfg.bucket_count,
                                         seed=tcfg.seed,
                                         max_mel_length=cfg.model.max_mel_length, shard=shard)
        return self.loader

    def _preempted(self, flag: bool) -> bool:
        """Whether any rank was signalled (one MAX over the world a step)."""
        if not self.layout.distributed:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(all_reduce(t, torch.distributed.group.WORLD,
                               torch.distributed.ReduceOp.MAX).item())

    def _train_call(self, n: int, db: dict, step: int, epoch: int) -> List[dict]:
        """Steps step + 1 .. step + n on `db` (stacked [n, ...] when n > 1);
        their losses, fetched from the device once."""
        if n == 1:
            losses = train_step(self.model, self.optimizer, self.config, db, step, epoch,
                                self.ema)
            names, values = list(losses), torch.stack([v.float() for v in losses.values()])[None]
        elif self.device.type == "cuda":
            if self._graph is None:
                self._graph = TrainStepGraph(self.model, self.optimizer, self.config, self.ema)
            names, values = self._graph.run(db, step, epoch)
        else:  # the plain version: n eager steps, one fetch
            calls = [train_step(self.model, self.optimizer, self.config, _row(db, i), step + i,
                                epoch, self.ema) for i in range(n)]
            names = list(calls[0])
            values = torch.stack([torch.stack([c[k].float() for k in names]) for c in calls])
        return [dict(zip(names, v)) for v in values.cpu().tolist()]  # waits for the call

    def _fit_loop(self, loader, max_steps, step, epoch, val_interval, preempt) -> List[dict]:
        cfg, tcfg = self.config, self.config.training
        es = tcfg.early_stopping
        best, stale, stop = float("inf"), 0, False
        k = steps_per_call(tcfg.steps_per_call, self.layout, self.is_main)
        grouped = k > 1
        prefetch = DevicePrefetcher(GroupedLoader(loader, k) if grouped else loader,
                                    self.device, tcfg.prefetch_batches, grouped=grouped)
        rows: List[dict] = []

        def crossed(interval, lo, hi):
            # a multiple of `interval` lies in the step window (lo, hi]
            return bool(interval) and hi // interval > lo // interval

        with (open(self.log_dir / "train_log.jsonl", "a", encoding="utf8") if self.is_main
              else contextlib.nullcontext()) as log:
            while step < max_steps and epoch < tcfg.max_epochs and not stop:
                self._epoch = epoch  # checkpoints store the live counter
                batches = iter(prefetch)
                t_free = time.perf_counter()
                try:
                    for item in batches:
                        n, batch, db = item if grouped else (1, *item)
                        if n > 1 and step + n > max_steps:
                            # split the tail group so the run stops at exactly max_steps
                            calls = [(1, _row(batch, i), _row(db, i))
                                     for i in range(max_steps - step)]
                        else:
                            calls = [(n, batch, db)]
                        for n_i, batch_i, db_i in calls:
                            t0 = time.perf_counter()
                            hosts = self._train_call(n_i, db_i, step, epoch)
                            prev, step = step, step + n_i
                            ms = (time.perf_counter() - t0) * 1e3
                            text, mel = batch_i["text"], batch_i["mel"]
                            # the global batch's [B, L, T]
                            shape = [int(text.shape[-2]) * self.layout.data_size,
                                     int(text.shape[-1]), int(mel.shape[-2])]
                            for s, host in enumerate(hosts, prev + 1):
                                row = {"step": s, "epoch": epoch, "shape": shape,
                                       "call_steps": n_i, "ms": ms / n_i,
                                       "wait_ms": (t0 - t_free) * 1e3 / n_i, **host}
                                if log is not None:
                                    log.write(json.dumps(row) + "\n")
                                rows.append(row)
                            if log is not None:
                                log.flush()
                            for s, host in enumerate(hosts, prev + 1):
                                self._guard_finite(host, s)
                                if (s == 1 or s % LOG_EVERY == 0) and self.is_main:
                                    for key, v in host.items():
                                        self._log("training/grad_norm" if key == "grad_norm"
                                                  else f"training/{key}_loss", v, s)
                                    print(f"step {s} epoch {epoch} total={host['total']:.4f} "
                                          f"spec={host.get('spec', 0.0):.4f} "
                                          f"{ms / n_i:.1f} ms", flush=True)
                            if self._preempted(preempt["flag"]):
                                if preempt["flag"] or self.is_main:
                                    print(f"received signal {preempt['signum']}: checkpointing "
                                          f"at step {step} and exiting cleanly", flush=True)
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
                                            if self.is_main:
                                                print(f"early stopping: {MONITOR} stale for "
                                                      f"{stale} validations", flush=True)
                                            stop = True
                                            break
                            if step >= max_steps:
                                break
                            t_free = time.perf_counter()
                        if stop or step >= max_steps:
                            break
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

    def _guard_finite(self, host: dict, step: int) -> None:
        """Halt on a non-finite loss (``training.halt_on_non_finite``): one
        Adam step through a NaN gradient poisons the moments for good."""
        if self.config.training.halt_on_non_finite and not all(map(math.isfinite,
                                                                   host.values())):
            raise TrainingDivergedError(
                f"non-finite training loss at step {step}: {host} — resume from the "
                "last good checkpoint (set training.halt_on_non_finite=false to "
                "override)")

    def validate(self, step: int, epoch: int) -> dict:
        """Weighted mean of each loss over the validation batches (each
        batch's mean weighted by its real rows, ``n_real_global``, so filler
        rows count for nothing); appends a row to ``val_log.jsonl`` and logs the means
        and the first batch's media to the event file. Outside ``fit`` it
        builds the loaders itself; ``close`` ends the event file after."""
        if self.val_loader is None:
            self._build_loaders()
            if self.is_main:
                self.log_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        sums: dict = {}
        total_w, n = 0.0, 0
        for batch in self.val_loader:
            losses, out = eval_step(self.model, self.config,
                                    batch_to_device(batch, self.device), epoch)
            if n == 0 and self.is_main:  # rank 0 holds the global batch's row 0
                try:
                    self._log_validation_media(step, batch, out)
                except Exception as e:  # as in JAX, media never stop training
                    print(f"validation media logging failed: {e}", flush=True)
            w = float(batch["n_real_global"])  # the global batch's real rows, on every rank
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v) * w
            total_w += w
            n += 1
        means = {k: v / max(total_w, 1e-9) for k, v in sums.items()}
        row = {"step": step, "epoch": epoch, "batches": n,
               "ms": (time.perf_counter() - t0) * 1e3, **means}
        if self.is_main:
            with open(self.log_dir / "val_log.jsonl", "a", encoding="utf8") as f:
                f.write(json.dumps(row) + "\n")
        for k, v in means.items():
            self._log(f"validation/{k}_loss", v, step)
        return means

    def _log_validation_media(self, step: int, batch: dict, out: dict) -> None:
        """The JAX trainer's validation media (``loop.py:724-891``) for the
        first item of a validation batch: the soft and hard attention, GT
        and predicted mels with pitch and energy (phone-level predictions
        expanded by the durations), the vocoded prediction, and at step 0
        the preprocessed audio and the vocoded GT mel. Only item 0 of the
        outputs and its lengths move to the host; the mels are vocoded at
        their padded width, as in JAX."""
        cfg = self.config
        name = batch["basename"][0]

        def row0(x: torch.Tensor) -> np.ndarray:
            return x[:1].detach().float().cpu().numpy()

        if cfg.model.learn_alignment and out.get("attn_soft") is not None:
            t, l = int(batch["mel_lens"][0]), int(batch["src_lens"][0])
            images = plotting.plot_attn_maps(row0(out["attn_soft"][:, :t, :l]),
                                             row0(out["attn_hard"][:, :t, :l]),
                                             batch["mel_lens"][:1], batch["src_lens"][:1], n=1)
            for i, image in enumerate(images):
                self.writer.add_image(f"attention/{batch['basename'][i]}", image, step)
        output_key = "postnet_output" if cfg.model.use_postnet else "output"
        vp = cfg.model.variance_predictors
        duration = row0(out["duration_target"])[0]
        curves = {}
        for kind in ("pitch", "energy"):
            gt, pred = batch[kind][0], row0(out[f"{kind}_prediction"])[0]
            if getattr(vp, kind).level == "phone":
                pred = plotting.expand(pred, duration)
                if not cfg.model.learn_alignment:
                    gt = plotting.expand(gt, duration)
            curves[kind] = (gt, pred)
        image = plotting.plot_mel(
            [{"mel": batch["mel"][0].T, "pitch": curves["pitch"][0],
              "energy": curves["energy"][0]},
             {"mel": row0(out[output_key])[0].T, "pitch": curves["pitch"][1],
              "energy": curves["energy"][1]}],
            self.stats, ["Ground-Truth Spectrogram", "Synthesized Spectrogram"])
        self.writer.add_image(f"pred/spec_{name}", image, step)

        a = cfg.preprocessing.audio
        if step == 0:
            try:
                from ..preprocessing.pipeline import load_wav

                audio_path = (Path(cfg.preprocessing.save_dir) / "audio" / "--".join(
                    [name, batch["speaker"][0], batch["language"][0],
                     f"audio-{a.input_sampling_rate}.wav"]))
                if audio_path.exists():
                    self.writer.add_audio(f"gt/wav_{name}",
                                          load_wav(audio_path, a.output_sampling_rate), step,
                                          a.output_sampling_rate)
            except Exception as e:  # as in JAX
                print(f"gt audio logging failed: {e}", flush=True)
        if cfg.training.vocoder_path:
            try:
                if self._media_vocoder is None:  # loaded once, not at every validation
                    from ..models.hifigan import load_vocoder_checkpoint

                    self._media_vocoder = load_vocoder_checkpoint(
                        Path(cfg.training.vocoder_path), device=self.device)[0]
                vocoder = self._media_vocoder
                wav = vocoder.device_fn(out[output_key][:1]).float().cpu().numpy()
                self.writer.add_audio(f"pred/wav_{name}", wav[0], step, vocoder.sample_rate)
                if step == 0:
                    cs, sr = vocoder(batch["mel"][:1])
                    self.writer.add_audio(f"copy-synthesis/wav_{name}", cs[0], step, sr)
            except Exception as e:  # as in JAX
                print(f"vocoder audio logging failed: {e}", flush=True)

    def _save(self, step: int, metrics: Optional[dict] = None) -> None:
        t0 = time.perf_counter()
        tcfg = self.config.training
        args = (self.config.to_dict(), self.stats_dict, self.lang2id, self.speaker2id,
                self.symbols)
        if self.layout.distributed:
            # every rank gathers (collective); rank 0 writes; no rank reads or
            # prunes before the write is published (JAX checkpoint.py:95-145)
            barrier()
            snap = take_snapshot(self.model, self.optimizer, self.ema, step, self._epoch)
            if self.is_main:
                save_checkpoint(self.ckpt_dir, snap, *args, metrics=metrics)
                prune_checkpoints(self.ckpt_dir, tcfg.save_top_k_ckpts, MONITOR)
            barrier()
        elif self._async is not None:
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
        plan = self.model.parallel_plan  # a full checkpoint; this rank keeps its slices
        self.model.load_state_dict(shard_state_dict(ckpt["state_dict"], plan),
                                   strict=True)
        set_variance_bins(self.model, self.stats, self.config)
        step, epoch, saved_ema = int(ckpt.get("global_step", 0)), 0, None
        if meta is not None:
            step, epoch = int(meta["global_step"]), int(meta.get("epoch") or 0)
            saved = meta.get("model_info", {}).get("version", MODEL_VERSION)
            migrated = (parse_version(saved) < parse_version(MODEL_VERSION)
                        and meta.get("symbols", []) != self.symbols)
            if not migrated:
                ts = load_train_state(path)
                self.optimizer.load_state(ts["mu"], ts["nu"], ts["count"])
                if ts.get("ema") is not None:
                    saved_ema = shard_state_dict(ts["ema"], plan)
        if self.ema is not None:
            with torch.no_grad():
                for name, e, p in zip(self.optimizer.names, self.ema, self.optimizer.params):
                    # EMA switched on since the save starts from the parameters
                    e.copy_(saved_ema[name] if saved_ema is not None else p)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_ms = (time.perf_counter() - t0) * 1e3
        if self.is_main:
            print(f"resumed from {path} at step {step}, epoch {epoch} "
                  f"({'weights only' if meta is None else 'full state'})", flush=True)
        return step, epoch
