"""FastSpeech2 training loss (a copy of the JAX package's
``training/loss.py:24-145``).

Masked MSE/MAE for pitch, energy and log-duration (target log(dur + 1)),
mel and postnet spec losses, the CTC forward-sum and binarization alignment
losses with the binarization weight warmed up linearly over epochs, and
their sum. As in the reference, the masked errors are averaged over every
element, padding included, so the bucket padding sets the denominator;
zero-weight rows (the loader's fill of a partial batch) leave both the
numerator and the denominator.

Under a data-parallel layout (``parallel.layout()``) each weighted mean is
a (numerator, denominator) pair over this rank's rows; the denominators are
summed over the data group (one all-reduce a step) and each loss is the
rank's numerator over the global denominator, its share of the global
batch's loss. Summing the ranks' gradients (``state.AdamWNoam``) and the
ranks' shares (``step.py``) then gives the one-process step on the global
batch."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.ctc import (
    attention_binarization_loss_parts,
    attention_ctc_loss,
    attention_ctc_loss_parts,
)
from ..parallel.mesh import all_reduce
from ..parallel.mesh import layout as parallel_layout


def _elem_loss(kind: str, pred, target, sample_weight: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(numerator, denominator) of the masked mean error; without weights
    (None) the mean and no denominator."""
    diff = (pred - target) ** 2 if kind == "mse" else torch.abs(pred - target)
    if sample_weight is None:
        return diff.mean(), None
    w = sample_weight.float()
    per_sample = 1
    for d in diff.shape[1:]:
        per_sample *= d
    wb = w.reshape((-1,) + (1,) * (diff.ndim - 1))
    return (diff * wb).sum(), w.sum() * per_sample


def compute_loss(config, output: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 current_epoch: int = 0) -> Dict[str, torch.Tensor]:
    """Weighted losses by name, and their sum under "total"; under a
    data-parallel layout, this rank's shares of them."""
    mcfg, tcfg = config.model, config.training
    vp = mcfg.variance_predictors
    group = parallel_layout().data_group
    parts: Dict[str, tuple] = {}  # name -> (numerator, denominator or None, factor)
    src_mask = output["src_mask"].float()
    tgt_mask = output["tgt_mask"].float()
    sw = batch.get("sample_weight")
    if sw is None and group is not None:  # each mean needs a denominator to sum
        sw = torch.ones(src_mask.shape[0], device=src_mask.device)
    if sw is not None:
        sw = sw.float()

    for name, cfg, weight in (("pitch", vp.pitch, tcfg.pitch_loss_weight),
                              ("energy", vp.energy, tcfg.energy_loss_weight)):
        if output[f"{name}_target"] is None:
            continue
        mask = src_mask if cfg.level == "phone" else tgt_mask
        parts[name] = (*_elem_loss(cfg.loss, output[f"{name}_prediction"] * mask,
                                   output[f"{name}_target"] * mask, sw), weight)

    log_duration_target = torch.log(output["duration_target"].float() + 1.0) * src_mask
    parts["duration"] = (*_elem_loss(
        vp.duration.loss, output["duration_prediction"] * src_mask, log_duration_target, sw),
        tcfg.duration_loss_weight)

    m3 = tgt_mask[:, :, None]
    spec_target = batch["mel"].float() * m3
    parts["spec"] = (*_elem_loss(mcfg.mel_loss, output["output"] * m3, spec_target, sw),
                     tcfg.mel_loss_weight)
    if mcfg.use_postnet:
        parts["postnet"] = (*_elem_loss(mcfg.mel_loss, output["postnet_output"] * m3,
                                        spec_target, sw), tcfg.postnet_loss_weight)

    if mcfg.learn_alignment:
        if sw is None:
            parts["attn_ctc"] = (attention_ctc_loss(
                output["attn_logprob"], batch["src_lens"], batch["mel_lens"]), None,
                tcfg.attn_ctc_loss_weight)
        else:
            parts["attn_ctc"] = (*attention_ctc_loss_parts(
                output["attn_logprob"], batch["src_lens"], batch["mel_lens"], sw),
                tcfg.attn_ctc_loss_weight)
        bin_warmup = min(float(current_epoch) / tcfg.attn_bin_loss_warmup_epochs, 1.0)
        num, den = attention_binarization_loss_parts(output["attn_hard"], output["attn_soft"],
                                                     sample_weight=sw)
        parts["attn_bin"] = (num, den, (bin_warmup, tcfg.attn_bin_loss_weight))

    names = [k for k, (_, den, _) in parts.items() if den is not None]
    if group is not None:
        dens = torch.stack([parts[k][1].float() for k in names])
        all_reduce(dens, group)
        for k, den in zip(names, dens):
            parts[k] = (parts[k][0], den, parts[k][2])
    losses: Dict[str, torch.Tensor] = {}
    for name, (num, den, factor) in parts.items():
        loss = num if den is None else num / torch.clamp(den, min=1.0)
        for f in factor if isinstance(factor, tuple) else (factor,):
            loss = loss * f
        losses[name] = loss
    losses["total"] = sum(losses.values())
    return losses
