"""Batched synthesis over prepared items, driving the writers (the
counterpart of the JAX package's ``synthesis/synthesize.py``
``synthesize_items``).

Items go through the model in their order, `batch_size` at a time, with
the text padded to a multiple of 16. Free-running batches run the decoder
at `max_target_len` frames (``model.max_mel_length`` by default), as the
JAX package does; teacher-forced batches at their longest target mel. Items
with a ``mel_style_reference`` (``prepare_data(style_reference=)``) condition
a global-style-token model on it; the batch's ``pfs`` reach a
phonological-feature model where the batch has them. The outputs reach the
writers as numpy arrays on the host."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..dataset import PAD_MULT_TEXT, FastSpeechDataset, _round_up, collate
from ..parallel.replicas import (
    Replicas,
    concat_rows,
    fill_count,
    make_replicas,
    pad_rows,
    replica_devices,
    split_batch,
)
from ..training.loss import compute_loss
from ..training.step import batch_to_device


def synthesize_items(
    items: List[dict],
    model,
    config,
    lang2id: dict,
    speaker2id: dict,
    writers: Dict[Any, Any],
    batch_size: Optional[int] = None,
    teacher_forcing: bool = False,
    control: Optional[Dict[str, float]] = None,
    max_target_len: Optional[int] = None,
    return_scores: bool = False,
    devices=None,
) -> None:
    """Synthesize `items` (``prepare_data``'s) with `model` on its device (or
    one replica a device of `devices`) and hand every batch's outputs to
    each writer, then call each writer's ``finalize`` where it has one.
    With `teacher_forcing` the durations come from the target mels under
    ``config.preprocessing.save_dir``; `return_scores` (with
    `teacher_forcing`) adds each utterance's losses."""
    batch_size = batch_size or config.training.batch_size
    devs = (replica_devices(devices) if devices is not None
            else [next(model.parameters()).device])
    n_rep = len(devs)
    # keep the dispatched batch a multiple of the replicas
    batch_size = max(batch_size // n_rep, 1) * n_rep
    if return_scores:
        batch_size = 1
    style_reference = any("mel_style_reference" in it for it in items)
    ds = FastSpeechDataset(items, config, lang2id, speaker2id,
                           teacher_forcing=teacher_forcing, inference=True,
                           style_reference=style_reference)
    max_target_len = max_target_len or config.model.max_mel_length
    # the JAX package hands the controls over as float32
    ctrl = {k: float(np.float32((control or {}).get(k, 1.0)))
            for k in ("pitch", "energy", "duration")}
    replicas, models = Replicas(devs), make_replicas(model, devs)

    def run(i: int, rows: dict):
        """Replica i's block: (its outputs on the host, its losses)."""
        db = batch_to_device(rows, devs[i])
        m = models[i]
        if teacher_forcing:
            out = m.forward_teacher_forced(db, ctrl)
        else:
            out = m(db["text"], db["src_lens"], int(rows["max_mel_len"]), control=ctrl,
                    speaker_id=db["speaker_id"], language_id=db["language_id"],
                    pfs=db.get("pfs"), mel_style_reference=db.get("mel_style_reference"))
        # the model's outputs are f32 (also in bf16 models), ints and masks
        host = {k: v.cpu().numpy() for k, v in out.items() if v is not None}
        losses = None
        if return_scores:
            with torch.no_grad():
                losses = {k: float(v) for k, v in compute_loss(config, out, db, 0).items()}
        return host, losses

    for start in range(0, len(ds), batch_size):
        samples = [ds[i] for i in range(start, min(start + batch_size, len(ds)))]
        n_true = len(samples)
        samples = pad_rows(samples, fill_count(n_true, n_rep))
        pad_text = _round_up(max(s["text"].shape[0] for s in samples), PAD_MULT_TEXT)
        has_mel = samples[0].get("mel") is not None
        batch = collate(samples, pad_text, None if has_mel else max_target_len,
                        learn_alignment=config.model.learn_alignment)
        res = replicas.map(run, split_batch(batch, n_rep, len(samples)))
        out_host = {k: concat_rows([r[0][k] for r in res]) for k in res[0][0]}
        if len(samples) != n_true:
            # slice off the fill rows before any writer sees them
            out_host, batch = (_trim_rows(d, len(samples), n_true) for d in (out_host, batch))
        if return_scores:
            # one utterance a batch: replica 0 holds it, the others its copies
            out_host["losses"] = res[0][1]
        for writer in writers.values():
            writer.on_predict_batch_end(out_host, batch)

    for writer in writers.values():
        if hasattr(writer, "finalize"):
            writer.finalize()


def _trim_rows(d: dict, rows: int, keep: int) -> dict:
    """`d` with every array or list of `rows` rows cut to its first `keep`."""
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.ndarray, list)) and getattr(v, "ndim", 1) > 0 and len(v) == rows:
            v = v[:keep]
        out[k] = v
    return out
