"""The trainer (counterpart of the JAX package's ``training/loop.py``
``Trainer.fit``, one device, no validation or resume).

``Trainer(config).fit(max_steps)`` reads ``stats.json`` under
``preprocessing.save_dir``, builds the model (flax's initial distributions,
variance bins from the stats), the bucketed loader and the optimizer on the
resolved device, and runs train steps until ``max_steps`` or
``training.max_epochs``. Every step appends one JSON line to
``<logger.save_dir>/<name>/<version>/train_log.jsonl``: the step, the epoch,
the batch's [B, L, T], the step's wall milliseconds and every loss. A
non-finite loss raises when ``training.halt_on_non_finite`` is set. At the
end it writes ``checkpoints/last.ckpt`` in the reference layout, which the
port's ``Synthesizer`` and server load."""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint import write_checkpoint
from ..dataset import BucketedLoader, load_datasets
from ..device import resolve_device
from ..models.fastspeech2 import FastSpeech2
from ..text import TextProcessor
from ..text.lookups import lookuptables_from_config
from ..type_definitions import Stats
from .state import AdamWNoam, init_like_flax
from .step import batch_to_device, train_step


class TrainingDivergedError(RuntimeError):
    pass


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
        stats = Stats.from_dict(self.stats_dict)
        self.lang2id, self.speaker2id = lookuptables_from_config(config)
        n_symbols = len(TextProcessor(config.text).symbols)
        model = FastSpeech2(config, n_symbols=n_symbols,
                            n_speakers=max(len(self.speaker2id), 1),
                            n_languages=max(len(self.lang2id), 1))
        init_like_flax(model, config.training.seed)
        vp = config.model.variance_predictors
        with torch.no_grad():
            for kind, st in (("pitch", stats.pitch), ("energy", stats.energy)):
                n_bins = getattr(vp, kind).n_bins
                getattr(model.variance_adaptor, f"{kind}_bins").copy_(torch.from_numpy(
                    np.linspace(st.norm_min, st.norm_max, n_bins - 1, dtype=np.float32)))
        self.model = model.to(self.device).train()
        logger = config.training.logger
        self.log_dir = Path(log_dir or Path(logger.save_dir) / logger.name / logger.version)
        self.ckpt_path = self.log_dir / "checkpoints" / "last.ckpt"

    def fit(self, max_steps: Optional[int] = None) -> List[dict]:
        """Train; returns the logged rows (one per step)."""
        cfg = self.config
        tcfg = cfg.training
        max_steps = max_steps or tcfg.max_steps
        train_ds, _ = load_datasets(cfg, self.lang2id, self.speaker2id)
        loader = BucketedLoader(train_ds, tcfg.batch_size, n_buckets=tcfg.bucket_count,
                                seed=tcfg.seed, use_weighted_sampler=tcfg.use_weighted_sampler,
                                max_mel_length=cfg.model.max_mel_length)
        optimizer = AdamWNoam(list(self.model.named_parameters()), tcfg)
        ema = ([p.detach().clone() for p in optimizer.params]
               if tcfg.ema_decay > 0 else None)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        rows: List[dict] = []
        step = epoch = 0
        with open(self.log_dir / "train_log.jsonl", "a", encoding="utf8") as log:
            while step < max_steps and epoch < tcfg.max_epochs:
                for batch in loader:
                    t0 = time.perf_counter()
                    losses = train_step(self.model, optimizer, cfg,
                                        batch_to_device(batch, self.device), step, epoch, ema)
                    host = {k: float(v) for k, v in losses.items()}  # waits for the step
                    step += 1
                    row = {"step": step, "epoch": epoch,
                           "shape": [*map(int, batch["text"].shape), int(batch["mel"].shape[1])],
                           "ms": (time.perf_counter() - t0) * 1e3, **host}
                    log.write(json.dumps(row) + "\n")
                    log.flush()
                    rows.append(row)
                    if tcfg.halt_on_non_finite and not all(map(math.isfinite, host.values())):
                        raise TrainingDivergedError(f"non-finite training loss at step {step}: {host}")
                    if step == 1 or step % 50 == 0:
                        print(f"step {step} epoch {epoch} total={host['total']:.4f} "
                              f"spec={host.get('spec', 0.0):.4f} {row['ms']:.1f} ms", flush=True)
                    if step >= max_steps:
                        break
                epoch += 1
        self.ema = ema
        state = {k: v.detach().cpu().numpy() for k, v in self.model.state_dict().items()}
        write_checkpoint(self.ckpt_path, state, cfg.to_dict(), self.stats_dict,
                         self.lang2id, self.speaker2id, global_step=step)
        return rows
