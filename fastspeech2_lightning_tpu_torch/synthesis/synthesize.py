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
) -> None:
    """Synthesize `items` (``prepare_data``'s) with `model` on its device and
    hand every batch's outputs to each writer, then call each writer's
    ``finalize`` where it has one. With `teacher_forcing` the durations come
    from the target mels under ``config.preprocessing.save_dir``;
    `return_scores` (with `teacher_forcing`) adds each utterance's losses."""
    batch_size = batch_size or config.training.batch_size
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
    device = next(model.parameters()).device

    for start in range(0, len(ds), batch_size):
        samples = [ds[i] for i in range(start, min(start + batch_size, len(ds)))]
        pad_text = _round_up(max(s["text"].shape[0] for s in samples), PAD_MULT_TEXT)
        has_mel = samples[0].get("mel") is not None
        batch = collate(samples, pad_text, None if has_mel else max_target_len,
                        learn_alignment=config.model.learn_alignment)
        db = batch_to_device(batch, device)
        if teacher_forcing:
            out = model.forward_teacher_forced(db, ctrl)
        else:
            out = model(db["text"], db["src_lens"], int(batch["max_mel_len"]), control=ctrl,
                        speaker_id=db["speaker_id"], language_id=db["language_id"],
                        pfs=db.get("pfs"), mel_style_reference=db.get("mel_style_reference"))
        # the model's outputs are f32 (also in bf16 models), ints and masks
        out_host = {k: v.cpu().numpy() for k, v in out.items() if v is not None}
        if return_scores:
            with torch.no_grad():
                losses = compute_loss(config, out, db, 0)
            out_host["losses"] = {k: float(v) for k, v in losses.items()}
        for writer in writers.values():
            writer.on_predict_batch_end(out_host, batch)

    for writer in writers.values():
        if hasattr(writer, "finalize"):
            writer.finalize()
