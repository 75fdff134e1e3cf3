"""FastSpeech2 training loss (a copy of the JAX package's
``training/loss.py:24-145``).

Masked MSE/MAE for pitch, energy and log-duration (target log(dur + 1)),
mel and postnet spec losses, the CTC forward-sum and binarization alignment
losses with the binarization weight warmed up linearly over epochs, and
their sum. As in the reference, the masked errors are averaged over every
element, padding included, so the bucket padding sets the denominator;
zero-weight rows (the loader's fill of a partial batch) leave both the
numerator and the denominator."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.ctc import attention_binarization_loss, attention_ctc_loss


def _elem_loss(kind: str, pred, target, sample_weight: Optional[torch.Tensor] = None):
    diff = (pred - target) ** 2 if kind == "mse" else torch.abs(pred - target)
    if sample_weight is None:
        return diff.mean()
    w = sample_weight.float()
    per_sample = 1
    for d in diff.shape[1:]:
        per_sample *= d
    wb = w.reshape((-1,) + (1,) * (diff.ndim - 1))
    return (diff * wb).sum() / torch.clamp(w.sum() * per_sample, min=1.0)


def compute_loss(config, output: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 current_epoch: int = 0) -> Dict[str, torch.Tensor]:
    """Weighted losses by name, and their sum under "total"."""
    mcfg, tcfg = config.model, config.training
    vp = mcfg.variance_predictors
    losses: Dict[str, torch.Tensor] = {}
    src_mask = output["src_mask"].float()
    tgt_mask = output["tgt_mask"].float()
    sw = batch.get("sample_weight")
    if sw is not None:
        sw = sw.float()

    for name, cfg, weight in (("pitch", vp.pitch, tcfg.pitch_loss_weight),
                              ("energy", vp.energy, tcfg.energy_loss_weight)):
        if output[f"{name}_target"] is None:
            continue
        mask = src_mask if cfg.level == "phone" else tgt_mask
        losses[name] = _elem_loss(cfg.loss, output[f"{name}_prediction"] * mask,
                                  output[f"{name}_target"] * mask, sw) * weight

    log_duration_target = torch.log(output["duration_target"].float() + 1.0) * src_mask
    losses["duration"] = _elem_loss(
        vp.duration.loss, output["duration_prediction"] * src_mask, log_duration_target, sw,
    ) * tcfg.duration_loss_weight

    m3 = tgt_mask[:, :, None]
    spec_target = batch["mel"].float() * m3
    losses["spec"] = _elem_loss(mcfg.mel_loss, output["output"] * m3, spec_target,
                                sw) * tcfg.mel_loss_weight
    if mcfg.use_postnet:
        losses["postnet"] = _elem_loss(mcfg.mel_loss, output["postnet_output"] * m3,
                                       spec_target, sw) * tcfg.postnet_loss_weight

    if mcfg.learn_alignment:
        losses["attn_ctc"] = attention_ctc_loss(
            output["attn_logprob"], batch["src_lens"], batch["mel_lens"], sample_weight=sw,
        ) * tcfg.attn_ctc_loss_weight
        bin_warmup = min(float(current_epoch) / tcfg.attn_bin_loss_warmup_epochs, 1.0)
        losses["attn_bin"] = attention_binarization_loss(
            output["attn_hard"], output["attn_soft"], sample_weight=sw,
        ) * bin_warmup * tcfg.attn_bin_loss_weight

    losses["total"] = sum(losses.values())
    return losses
