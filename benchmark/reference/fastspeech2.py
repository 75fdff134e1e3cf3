"""Plain FastSpeech2 (Conformer encoder and decoder, learned alignment,
variance adaptor, PostNet), its training loss and its optimizer, in float32.

Written from the model's description (FastSpeech 2, arXiv:2006.04558; the
Conformer, arXiv:2005.08100; the learned alignment of "One TTS Alignment to
Rule Them All", arXiv:2108.10447) as EveryVoice's FastSpeech2_lightning
composes them, and frozen against the port's plain versions: parameters are
a dict keyed by the port's state_dict names, and every random draw of a
training step (dropout bits from a ``torch.Generator`` seeded by the step,
attention dropout by a 32-bit hash of (seed, stream, row, column)) is made
in the step's order, so a reference step sees the masks the program's step
sees. The products go through ``Numerics``, which is float32 for the
reference and a lower precision for its controls.

Nothing here imports the program or JAX. The CTC forward-sum loss is
``F.ctc_loss`` in float64; the monotonic alignment search is the plain
dynamic programme row by row."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics

NEG_INF = -1e9
LOSS_KEYS = ("pitch", "energy", "duration", "spec", "postnet", "attn_ctc", "attn_bin")


# -- parameters ----------------------------------------------------------------


def _conformer_spec(prefix: str, c: dict) -> Dict[str, tuple]:
    d, ff, k = c["input_dim"], c["feedforward_dim"], c["conv_kernel_size"]
    out = {}
    for i in range(c["layers"]):
        p = f"{prefix}.conformer_layers.{i}."
        for ffn in ("ffn1", "ffn2"):
            out.update({p + f"{ffn}.sequential.0.weight": (d,), p + f"{ffn}.sequential.0.bias": (d,),
                        p + f"{ffn}.sequential.1.weight": (ff, d),
                        p + f"{ffn}.sequential.1.bias": (ff,),
                        p + f"{ffn}.sequential.4.weight": (d, ff),
                        p + f"{ffn}.sequential.4.bias": (d,)})
        out.update({p + "self_attn_layer_norm.weight": (d,), p + "self_attn_layer_norm.bias": (d,),
                    p + "self_attn.in_proj_weight": (3 * d, d), p + "self_attn.in_proj_bias": (3 * d,),
                    p + "self_attn.out_proj.weight": (d, d), p + "self_attn.out_proj.bias": (d,),
                    p + "conv_module.layer_norm.weight": (d,),
                    p + "conv_module.layer_norm.bias": (d,),
                    p + "conv_module.sequential.0.weight": (2 * d, d, 1),
                    p + "conv_module.sequential.0.bias": (2 * d,),
                    p + "conv_module.sequential.2.weight": (d, 1, k),
                    p + "conv_module.sequential.2.bias": (d,),
                    p + "conv_module.sequential.3.weight": (d,),
                    p + "conv_module.sequential.3.bias": (d,),
                    p + "conv_module.sequential.5.weight": (d, d, 1),
                    p + "conv_module.sequential.5.bias": (d,),
                    p + "final_layer_norm.weight": (d,), p + "final_layer_norm.bias": (d,)})
    return out


def param_spec(cfg: dict, n_symbols: int) -> Dict[str, tuple]:
    """Every trainable parameter's name and shape (the port's state_dict
    names; buffers such as the variance bins are not parameters)."""
    m = cfg["model"]
    d = m["encoder"]["input_dim"]
    n_mels = cfg["preprocessing"]["audio"]["n_mels"]
    spec = {"text_input_layer.weight": (n_symbols, d)}
    spec.update(_conformer_spec("encoder", m["encoder"]))
    va = "variance_adaptor."
    for kind in ("duration", "pitch", "energy"):
        v = m["variance_predictors"][kind]
        c, k = v["input_dim"], v["kernel_size"]
        for i in range(v["n_layers"]):
            p = f"{va}{kind}_predictor.conv.{i}.layers."
            cin = d if i == 0 else c
            spec.update({p + "0.module.model.0.weight": (cin, 1, k),
                         p + "0.module.model.0.bias": (cin,),
                         p + "0.module.model.1.weight": (c, cin, 1),
                         p + "0.module.model.1.bias": (c,),
                         p + "2.weight": (c,), p + "2.bias": (c,)})
        spec[f"{va}{kind}_predictor.linear.weight"] = (1, c)
        spec[f"{va}{kind}_predictor.linear.bias"] = (1,)
    for kind in ("pitch", "energy"):
        v = m["variance_predictors"][kind]
        spec[f"{va}{kind}_embedding.weight"] = (v["n_bins"], v["input_dim"])
    a = va + "attention."
    spec.update({a + "key_proj.0.conv.weight": (2 * d, d, 3), a + "key_proj.0.conv.bias": (2 * d,),
                 a + "key_proj.2.conv.weight": (n_mels, 2 * d, 1),
                 a + "key_proj.2.conv.bias": (n_mels,),
                 a + "query_proj.0.conv.weight": (2 * n_mels, n_mels, 3),
                 a + "query_proj.0.conv.bias": (2 * n_mels,),
                 a + "query_proj.2.conv.weight": (n_mels, 2 * n_mels, 1),
                 a + "query_proj.2.conv.bias": (n_mels,),
                 a + "query_proj.4.conv.weight": (n_mels, n_mels, 1),
                 a + "query_proj.4.conv.bias": (n_mels,)})
    spec.update(_conformer_spec("decoder", m["decoder"]))
    dd = m["decoder"]["input_dim"]
    spec.update({"mel_linear.weight": (n_mels, dd), "mel_linear.bias": (n_mels,)})
    for i in range(5):
        cin = n_mels if i == 0 else 512
        cout = n_mels if i == 4 else 512
        p = f"postnet.convolutions.{i}."
        spec.update({p + "0.conv.weight": (cout, cin, 5), p + "0.conv.bias": (cout,),
                     p + "1.weight": (cout,), p + "1.bias": (cout,)})
    return spec


# -- randomness of a training step -----------------------------------------------


def step_generator_seed(seed: int, step: int) -> int:
    """The generator seed of step `step`: numpy's SeedSequence of (seed, step)."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    """One uint8 of random bits an element; keep iff bits >= round(256 rate);
    kept values scaled by 256 / (256 - t)."""
    if gen is None or rate == 0.0:
        return x
    t = int(round(rate * 256.0))
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, generator=gen, device=x.device)
    return torch.where(bits >= t, x * (256.0 / (256 - t)), torch.zeros_like(x))


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def attention_keep(seed: int, B: int, H: int, T: int, p: float, device) -> torch.Tensor:
    """[B, H, T, T] keep mask: 32 hash bits of (seed, stream b * H + h, query
    row, key column) against floor(p 2^32)."""
    thresh = min(int(p * (1 << 32)), (1 << 32) - 1)
    bh = torch.arange(B * H, dtype=torch.int64, device=device)
    key = _mix32((int(seed) & _M32) ^ _mix32((_mul32(bh, 0x9E3779B9) + 0x632BE5AB) & _M32))
    r = torch.arange(T, dtype=torch.int64, device=device)
    rows, cols = r[:, None], r[None, :]
    low = ((rows & 0xFFFF) << 16) | (cols & 0xFFFF)
    high = _mix32(((rows >> 16) << 16) | (cols >> 16))
    keep = torch.empty(B * H, T, T, dtype=torch.bool, device=device)
    for i in range(B * H):  # a stream at a time keeps the int64 temporaries small
        keep[i] = _mix32((low ^ high) ^ key[i]) >= thresh
    return keep.view(B, H, T, T)


# -- layers ----------------------------------------------------------------------


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def positions(T: int, dim: int, device) -> torch.Tensor:
    """FastPitch's sinusoids: [sin(all), cos(all)] of pos / 10000^(2i/dim)."""
    inv = 1.0 / (10000 ** (torch.arange(0.0, dim, 2.0, device=device) / dim))
    s = torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(s), torch.cos(s)], dim=1)[:, :dim]


class Model:
    """A forward over `params` (name -> tensor) for the config dict `cfg`."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, num: Numerics,
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
        self.P, self.cfg, self.num, self.B = params, cfg, num, buffers or {}
        self.m = cfg["model"]

    # conformer
    def ffn(self, p, x, rate, gen):
        P, n = self.P, self.num
        h = layer_norm(x, P[p + "sequential.0.weight"], P[p + "sequential.0.bias"])
        h = F.silu(n.linear(h, P[p + "sequential.1.weight"], P[p + "sequential.1.bias"]))
        h = dropout(h, rate, gen)
        return dropout(n.linear(h, P[p + "sequential.4.weight"], P[p + "sequential.4.bias"]),
                       rate, gen)

    def self_attention(self, p, x, mask, heads, rate, att_rate, gen):
        P, n = self.P, self.num
        B, T, d = x.shape
        dh = d // heads
        qkv = n.linear(x, P[p + "in_proj_weight"], P[p + "in_proj_bias"]).view(B, T, 3, heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        s = n.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        s = s + torch.where(mask, 0.0, NEG_INF)[:, None, None, :]
        prob = torch.softmax(s, dim=-1)
        if gen is not None:
            seed = torch.randint(-(2**31), 2**31 - 1, (1,), generator=gen, device=x.device,
                                 dtype=torch.int32)
            if att_rate > 0:
                keep = attention_keep(int(seed.item()), B, heads, T, att_rate, x.device)
                prob = torch.where(keep, prob / (1.0 - att_rate), 0.0)
                del keep
        out = n.matmul(prob, v).transpose(1, 2).reshape(B, T, d)
        return dropout(n.linear(out, P[p + "out_proj.weight"], P[p + "out_proj.bias"]), rate, gen)

    def conv_module(self, p, x, mask, rate, gen):
        P, n = self.P, self.num
        s = p + "sequential."
        h = layer_norm(x, P[p + "layer_norm.weight"], P[p + "layer_norm.bias"]).transpose(1, 2)
        h = F.glu(n.conv1d(h, P[s + "0.weight"], P[s + "0.bias"]), dim=1)
        h = h * mask[:, None, :].float()
        h = n.conv1d(h, P[s + "2.weight"], P[s + "2.bias"], padding="same", groups=h.shape[1])
        h = h.transpose(1, 2)
        w, b = P[s + "3.weight"], P[s + "3.bias"]
        if gen is None:  # inference: the running statistics
            mean, var = self.B[s + "3.running_mean"], self.B[s + "3.running_var"]
        else:  # training: the valid frames' batch statistics
            m = mask[:, :, None].float()
            count = torch.clamp(m.sum(), min=1.0)
            mean = (h * m).sum((0, 1)) / count
            var = (((h - mean) ** 2) * m).sum((0, 1)) / count
        h = (h - mean) * torch.rsqrt(var + 1e-5) * w + b
        h = F.silu(h)
        h = n.conv1d(h.transpose(1, 2), P[s + "5.weight"], P[s + "5.bias"]).transpose(1, 2)
        return dropout(h, rate, gen)

    def conformer(self, prefix, c, x, mask, gen):
        rate = c["dropout"]
        att = rate if c.get("attention_dropout") is None else c["attention_dropout"]
        for i in range(c["layers"]):
            p = f"{prefix}.conformer_layers.{i}."
            x = x + 0.5 * self.ffn(p + "ffn1.", x, rate, gen)
            h = layer_norm(x, self.P[p + "self_attn_layer_norm.weight"],
                           self.P[p + "self_attn_layer_norm.bias"])
            x = x + self.self_attention(p + "self_attn.", h, mask, c["heads"], rate, att, gen)
            x = x + self.conv_module(p + "conv_module.", x, mask, rate, gen)
            x = x + 0.5 * self.ffn(p + "ffn2.", x, rate, gen)
            x = layer_norm(x, self.P[p + "final_layer_norm.weight"],
                           self.P[p + "final_layer_norm.bias"])
        return x * mask[:, :, None].float()

    # variance adaptor
    def predictor(self, kind, x, mask, gen):
        P, n = self.P, self.num
        v = self.m["variance_predictors"][kind]
        base = f"variance_adaptor.{kind}_predictor."
        h = x
        for i in range(v["n_layers"]):
            p = f"{base}conv.{i}.layers."
            t = h.transpose(1, 2)
            t = n.conv1d(t, P[p + "0.module.model.0.weight"], P[p + "0.module.model.0.bias"],
                         padding="same", groups=t.shape[1])
            t = n.conv1d(t, P[p + "0.module.model.1.weight"], P[p + "0.module.model.1.bias"])
            t = torch.relu(t.transpose(1, 2))
            h = dropout(layer_norm(t, P[p + "2.weight"], P[p + "2.bias"]), v["dropout"], gen)
        out = n.linear(h, P[base + "linear.weight"], P[base + "linear.bias"]).squeeze(-1)
        return out * mask.float()

    def alignment(self, mel, text_emb, src_mask, prior):
        """(soft attention, log-probabilities) of the mel frames over the text."""
        P, n = self.P, self.num
        a = "variance_adaptor.attention."
        k = text_emb.transpose(1, 2)
        k = n.conv1d(k, P[a + "key_proj.0.conv.weight"], P[a + "key_proj.0.conv.bias"],
                     padding="same")
        k = n.conv1d(torch.relu(k), P[a + "key_proj.2.conv.weight"],
                     P[a + "key_proj.2.conv.bias"]).transpose(1, 2)
        q = mel.float().transpose(1, 2)
        q = torch.relu(n.conv1d(q, P[a + "query_proj.0.conv.weight"],
                                P[a + "query_proj.0.conv.bias"], padding="same"))
        q = torch.relu(n.conv1d(q, P[a + "query_proj.2.conv.weight"],
                                P[a + "query_proj.2.conv.bias"]))
        q = n.conv1d(q, P[a + "query_proj.4.conv.weight"],
                     P[a + "query_proj.4.conv.bias"]).transpose(1, 2)
        s = -0.0005 * ((q * q).sum(-1, keepdim=True) + (k * k).sum(-1)[:, None, :]
                       - 2.0 * n.matmul(q, k.transpose(1, 2)))
        logprob = torch.log_softmax(s, dim=-1) + torch.log(prior.float() + 1e-8)
        soft = torch.softmax(torch.where(src_mask[:, None, :], logprob, -torch.inf), dim=-1)
        return soft, logprob

    def embed(self, kind, values):
        bins = self.bins[kind]
        return self.P[f"variance_adaptor.{kind}_embedding.weight"][
            torch.bucketize(values, bins.to(values.dtype), right=False)]

    def encode(self, text, src_lens, gen):
        L = text.shape[1]
        src_mask = torch.arange(L, device=text.device)[None, :] < src_lens[:, None]
        emb = self.P["text_input_layer.weight"][text.long()]
        pos = positions(L, emb.shape[-1], text.device)[None] * src_mask[:, :, None].float()
        return emb, self.conformer("encoder", self.m["encoder"], emb + pos, src_mask, gen), src_mask

    def decode(self, frames, tgt_mask, gen):
        P, n = self.P, self.num
        T = frames.shape[1]
        pos = positions(T, frames.shape[-1], frames.device)[None] * tgt_mask[:, :, None].float()
        x = self.conformer("decoder", self.m["decoder"], frames + pos, tgt_mask, gen)
        out = n.linear(x, P["mel_linear.weight"], P["mel_linear.bias"])
        h = out.transpose(1, 2)
        for i in range(5):
            p = f"postnet.convolutions.{i}."
            h = n.conv1d(h, P[p + "0.conv.weight"], P[p + "0.conv.bias"], padding="same")
            t = h.transpose(1, 2)
            if gen is None:
                mean, var = self.B[p + "1.running_mean"], self.B[p + "1.running_var"]
            else:  # every position's statistics, padding included
                mean = t.mean((0, 1))
                var = torch.clamp((t * t).mean((0, 1)) - mean * mean, min=0.0)
            t = (t - mean) * (torch.rsqrt(var + 1e-5) * P[p + "1.weight"]) + P[p + "1.bias"]
            if i < 4:
                t = torch.tanh(t)
            h = dropout(t, 0.5, gen).transpose(1, 2)
        return out, out + h.transpose(1, 2)

    def forward_train(self, batch: dict, bins: dict, gen: torch.Generator) -> dict:
        """The training forward with batch statistics and dropout from `gen`."""
        self.bins = bins
        mel, src_lens, mel_lens = batch["mel"], batch["src_lens"], batch["mel_lens"]
        emb, x, src_mask = self.encode(batch["text"], src_lens, gen)
        soft, logprob = self.alignment(mel, emb, src_mask, batch["attn_prior"])
        hard, dur = mas(torch.log(torch.clamp(soft.detach(), min=1e-20)), src_lens, mel_lens)
        energy_t = average_variance(batch["energy"], dur)
        pitch_t = average_variance(batch["pitch"], dur)
        energy_p = self.predictor("energy", x, src_mask, gen)
        x = x + self.embed("energy", energy_t)
        pitch_p = self.predictor("pitch", x, src_mask, gen)
        x = x + self.embed("pitch", pitch_t)
        logdur_p = self.predictor("duration", x, src_mask, gen)
        frames, tgt_mask = length_regulate(x, dur, mel.shape[1])
        out, post = self.decode(frames, tgt_mask, gen)
        return dict(output=out, postnet_output=post, src_mask=src_mask, tgt_mask=tgt_mask,
                    attn_logprob=logprob, attn_soft=soft, attn_hard=hard,
                    duration_prediction=logdur_p, duration_target=dur,
                    energy_prediction=energy_p, energy_target=energy_t,
                    pitch_prediction=pitch_p, pitch_target=pitch_t)

    def forward_inference(self, text, src_lens, durations, T: int, bins: dict) -> dict:
        """The inference forward (no dropout) at given integer durations,
        length-regulated to T frames: the mel, the PostNet mel and the
        predicted log-durations. BatchNorm takes running statistics, which
        the served weights hold (``buffers``)."""
        self.bins = bins
        emb, x, src_mask = self.encode(text, src_lens, None)
        energy_p = self.predictor("energy", x, src_mask, None)
        x = x + self.embed("energy", energy_p)
        pitch_p = self.predictor("pitch", x, src_mask, None)
        x = x + self.embed("pitch", pitch_p)
        logdur_p = self.predictor("duration", x, src_mask, None)
        frames, tgt_mask = length_regulate(x, durations, T)
        out, post = self.decode(frames, tgt_mask, None)
        return dict(output=out, postnet_output=post, duration_prediction=logdur_p,
                    tgt_mask=tgt_mask)


# -- alignment and regulation ------------------------------------------------------


@torch.no_grad()
def mas(log_attn, in_lens, out_lens):
    """Width-1 monotonic alignment search: (one-hot path [B, T, L], durations)."""
    B, T, L = log_attn.shape
    dev = log_attn.device
    j = torch.arange(L, device=dev)
    i = torch.arange(T, device=dev)
    valid = (j[None, None, :] < in_lens[:, None, None]) & (i[None, :, None] < out_lens[:, None, None])
    la = torch.where(valid, torch.clamp(log_attn.float(), min=NEG_INF), NEG_INF)
    first = j == 0
    neg = torch.full((B, 1), NEG_INF, device=dev)
    prev = la[:, 0] + torch.where(first, 0.0, NEG_INF)
    moves = torch.zeros((B, T, L), dtype=torch.bool, device=dev)
    for t in range(1, T):
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        moves[:, t] = (shifted >= prev) & ~first
        prev = torch.clamp(la[:, t] + torch.maximum(prev, shifted), min=NEG_INF)
    in_l, out_l = in_lens.long(), out_lens.long()
    ok = (out_l > 0) & (in_l > 0) & (in_l <= L)
    c = torch.where(ok, in_l - 1, 0)[:, None]
    hard = torch.zeros((B, T, L), device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(T - 1, 0, -1):
        active = ok & (t < out_l)
        hard[:, t].scatter_(1, c, active.float()[:, None])
        c = c - (active & moves[rows, t, c[:, 0]]).long()[:, None]
    hard[:, 0].scatter_(1, c, ok.float()[:, None])
    return hard, hard.sum(1).long()


def average_variance(var, durs):
    """Each symbol's mean of its non-zero frames of `var` (0 where none)."""
    T = var.shape[1]
    ends = torch.clamp(torch.cumsum(durs.long(), 1), 0, T)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    zero = torch.zeros_like(var[:, :1])
    cums = torch.cat([zero, torch.cumsum(var.double(), 1)], 1)
    cnt = torch.cat([zero, torch.cumsum((var != 0).double(), 1)], 1)
    s = cums.gather(1, ends) - cums.gather(1, starts)
    n = cnt.gather(1, ends) - cnt.gather(1, starts)
    return torch.where(n == 0, 0.0, s / torch.clamp(n, min=1.0)).float()


def length_regulate(x, durs, T: int):
    """x [B, L, D] repeated by integer durations into [B, T, D], and the mask."""
    ends = torch.cumsum(durs.long(), 1)
    lens = torch.clamp(ends[:, -1], max=T)
    frame = torch.arange(T, device=x.device)
    idx = torch.searchsorted(ends, frame.expand(ends.shape[0], -1).contiguous(), right=True)
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    mask = frame[None, :] < lens[:, None]
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return out * mask[:, :, None].float(), mask


# -- loss ----------------------------------------------------------------------------


def _wmean(diff, w):
    per = diff[0].numel()
    wb = w.reshape((-1,) + (1,) * (diff.ndim - 1))
    return (diff * wb).sum() / torch.clamp(w.sum() * per, min=1.0)


def compute_loss(cfg: dict, out: dict, batch: dict, epoch: int = 0) -> Dict[str, torch.Tensor]:
    """Weighted losses by name, and their sum under "total"."""
    t = cfg["training"]
    vp = cfg["model"]["variance_predictors"]
    w = batch["sample_weight"].float()
    sm, tm = out["src_mask"].float(), out["tgt_mask"].float()[:, :, None]

    def err(kind, a, b):
        return (a - b) ** 2 if kind == "mse" else (a - b).abs()

    L = {}
    for name in ("pitch", "energy"):
        L[name] = t[f"{name}_loss_weight"] * _wmean(
            err(vp[name]["loss"], out[f"{name}_prediction"] * sm, out[f"{name}_target"] * sm), w)
    logdur = torch.log(out["duration_target"].float() + 1.0) * sm
    L["duration"] = t["duration_loss_weight"] * _wmean(
        err(vp["duration"]["loss"], out["duration_prediction"] * sm, logdur), w)
    target = batch["mel"].float() * tm
    kind = cfg["model"]["mel_loss"]
    L["spec"] = t["mel_loss_weight"] * _wmean(err(kind, out["output"] * tm, target), w)
    L["postnet"] = t["postnet_loss_weight"] * _wmean(
        err(kind, out["postnet_output"] * tm, target), w)
    L["attn_ctc"] = t["attn_ctc_loss_weight"] * ctc_loss(
        out["attn_logprob"], batch["src_lens"], batch["mel_lens"], w)
    hard = out["attn_hard"] * w[:, None, None]
    log_soft = torch.log(torch.clamp(out["attn_soft"], min=1e-12))
    warm = min(float(epoch) / t["attn_bin_loss_warmup_epochs"], 1.0)
    L["attn_bin"] = (-(log_soft * hard).sum() / torch.clamp(hard.sum(), min=1.0)
                     * warm * t["attn_bin_loss_weight"])
    L["total"] = sum(L.values())
    return L


def ctc_loss(attn_logprob, in_lens, out_lens, w):
    """The forward-sum loss: CTC of the labels 1..in_len over a blank column
    at -1 and the text columns, each example over its text length, weighted."""
    B, T, L = attn_logprob.shape
    blank = torch.full((B, T, 1), -1.0, device=attn_logprob.device)
    logits = torch.cat([blank, attn_logprob.float()], -1).double()
    cols = torch.arange(L + 1, device=logits.device)[None, None, :]
    logits = torch.where(cols > in_lens[:, None, None], -1e15, logits)
    lp = torch.log_softmax(logits, -1)
    targets = torch.arange(1, L + 1, device=lp.device).expand(B, L)
    nll = F.ctc_loss(lp.transpose(0, 1), targets, out_lens.long(), in_lens.long(), blank=0,
                     reduction="none", zero_infinity=True)
    per = (nll / torch.clamp(in_lens.double(), min=1.0)).float()
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


# -- optimizer -------------------------------------------------------------------------


class AdamWNoam:
    """Global-norm clip, Adam with bias correction, decoupled weight decay
    and the Noam rate of the update count, over `names` of `params`."""

    def __init__(self, params: Dict[str, torch.Tensor], tcfg: dict):
        o = tcfg["optimizer"]
        self.params, self.names = params, list(params)
        self.lr, self.warmup = o["learning_rate"], o["warmup_steps"]
        self.b1, self.b2 = o["betas"]
        self.eps, self.wd, self.clip = o["eps"], o["weight_decay"], tcfg["gradient_clip_val"]
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> float:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = 1.0 if norm < self.clip else self.clip / norm
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        step = max(float(self.count - 1), 1.0)
        lr = self.lr * self.warmup ** 0.5 * min(step ** -0.5, step * self.warmup ** -1.5)
        for k in self.names:
            g = grads[k] * scale
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            self.params[k].add_((upd + self.wd * self.params[k]) * (-lr))
        return float(norm)


def train_steps(params: Dict[str, torch.Tensor], bins: dict, cfg: dict, batches: List[dict],
                seed: int, num: Numerics, first_step: int = 0, epoch: int = 0) -> dict:
    """Run one training step a batch from `params` (updated in place):
    returns {"losses": [per step {name: float}], "mu": {name: tensor}}."""
    model = Model(params, cfg, num)
    opt = AdamWNoam(params, cfg["training"])
    rows = []
    for i, batch in enumerate(batches):
        dev = batch["text"].device
        gen = torch.Generator(device=dev).manual_seed(
            step_generator_seed(seed, first_step + i))
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        out = model.forward_train(batch, bins, gen)
        losses = compute_loss(cfg, out, batch, epoch)
        losses["total"].backward()
        del out
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        row = {k: float(v.detach()) for k, v in losses.items()}
        row["grad_norm"] = opt.step(grads)
        rows.append(row)
        for p in params.values():
            p.grad = None
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": rows, "mu": opt.mu}
