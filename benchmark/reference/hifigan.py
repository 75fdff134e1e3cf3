"""Plain HiFiGAN (arXiv:2010.05646; jik876/hifi-gan): the V1 generator, the
multi-period and multi-scale discriminators with weight-normed convs, the
log-mel, the LSGAN, feature-matching and mel losses, and AdamW, in float32.

Parameters are dicts keyed by the port's state_dict names. Products go
through ``Numerics``. Nothing here imports the program or JAX."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics

SLOPE = 0.1
LOG_CLIP = 1e-5


def lrelu(x):
    """Leaky ReLU whose derivative at exactly 0 is 1."""
    return torch.where(x >= 0, x, SLOPE * x)


# -- generator -----------------------------------------------------------------


def generator_spec(v: dict) -> Dict[str, tuple]:
    """name -> (shape, kind) with kind "conv", "up" (transposed) or "bias"."""
    ch = v["upsample_initial_channel"]
    spec = {"conv_pre.weight": ((ch, v["n_mels"], 7), "conv"), "conv_pre.bias": ((ch,), "bias")}
    n = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        cout = ch // 2
        spec[f"ups.{i}.weight"] = ((ch, cout, k), "up")
        spec[f"ups.{i}.bias"] = ((cout,), "bias")
        for j, (rk, dils) in enumerate(zip(v["resblock_kernel_sizes"],
                                           v["resblock_dilation_sizes"])):
            for d in range(len(dils)):
                for name in ("convs1", "convs2"):
                    p = f"resblocks.{i * n + j}.{name}.{d}."
                    spec[p + "weight"] = ((cout, cout, rk), "conv")
                    spec[p + "bias"] = ((cout,), "bias")
        ch = cout
    spec["conv_post.weight"] = ((1, ch, 7), "conv")
    spec["conv_post.bias"] = ((1,), "bias")
    return spec


def generator(P: Dict[str, torch.Tensor], mel: torch.Tensor, v: dict, num: Numerics,
              num_mrf: Optional[Numerics] = None):
    """mel [B, T, n_mels] -> wav [B, T * hop]. `num_mrf`, where given, takes
    the resblock convs of the stages at 128 channels or fewer (the ones a
    served vocoder fuses into MRF kernels) and `num` every other conv."""
    x = num.conv1d(mel.float().transpose(1, 2), P["conv_pre.weight"], P["conv_pre.bias"],
                   padding="same")
    n = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        x = num.conv_transpose1d(F.leaky_relu(x, SLOPE), P[f"ups.{i}.weight"],
                                 P[f"ups.{i}.bias"], stride=u, padding=(k - u) // 2)
        acc = 0.0
        rb = num_mrf if num_mrf is not None and x.shape[1] <= 128 else num
        for j, dils in enumerate(v["resblock_dilation_sizes"]):
            h = x
            for d, dil in enumerate(dils):
                p = f"resblocks.{i * n + j}."
                t = rb.conv1d(F.leaky_relu(h, SLOPE), P[p + f"convs1.{d}.weight"],
                              P[p + f"convs1.{d}.bias"], padding="same", dilation=dil)
                t = rb.conv1d(F.leaky_relu(t, SLOPE), P[p + f"convs2.{d}.weight"],
                              P[p + f"convs2.{d}.bias"], padding="same")
                h = h + t
            acc = acc + h
        x = acc / n
    x = num.conv1d(F.leaky_relu(x, SLOPE), P["conv_post.weight"], P["conv_post.bias"],
                   padding="same")
    return torch.tanh(x)[:, 0]


# -- discriminators ----------------------------------------------------------------


def msd_groups(d: dict, j: int, cin: int) -> int:
    g = d["msd_groups"][j]
    return g if cin % g == 0 and d["msd_channels"][j] % g == 0 else 1


def discriminator_spec(d: dict) -> Dict[str, tuple]:
    """name -> shape of every weight-normed conv's v, g, b."""
    spec = {}

    def conv(prefix, cout, cin, kernel):
        spec[prefix + "v"] = (cout, cin, *kernel)
        spec[prefix + "g"] = (cout, 1, *([1] * len(kernel)))
        spec[prefix + "b"] = (cout,)

    for i in range(len(d["periods"])):
        cin = 1
        for j, cout in enumerate(d["mpd_channels"]):
            conv(f"mpd.{i}.layers.{j}.", cout, cin, (5, 1))
            cin = cout
        conv(f"mpd.{i}.post.", 1, cin, (3, 1))
    for i in range(d["n_scales"]):
        cin = 1
        for j, (cout, k) in enumerate(zip(d["msd_channels"], d["msd_kernels"])):
            conv(f"msd.{i}.layers.{j}.", cout, cin // msd_groups(d, j, cin), (k,))
            cin = cout
        conv(f"msd.{i}.post.", 1, cin, (3,))
    return spec


def _wn(P, prefix):
    v, g = P[prefix + "v"], P[prefix + "g"]
    dims = tuple(range(1, v.ndim))
    return g * v / torch.sqrt((v * v).sum(dims, keepdim=True) + 1e-12), P[prefix + "b"]


def discriminators(P, wav: torch.Tensor, d: dict, num: Numerics):
    """wav [B, N] -> (scores, features) of every sub-discriminator, the
    periods' first, then the scales'."""
    scores, feats = [], []
    B, N = wav.shape
    for i, p in enumerate(d["periods"]):
        pad = (-N) % p
        x = F.pad(wav[:, None], (0, pad), mode="reflect")[:, 0] if pad else wav
        x = x.reshape(B, 1, -1, p)
        f = []
        n = len(d["mpd_channels"])
        for j in range(n):
            w, b = _wn(P, f"mpd.{i}.layers.{j}.")
            x = lrelu(num.conv2d(x, w, b, stride=(3 if j < n - 1 else 1, 1), padding=(2, 0)))
            f.append(x)
        w, b = _wn(P, f"mpd.{i}.post.")
        x = num.conv2d(x, w, b, padding=(1, 0))
        f.append(x)
        scores.append(x.reshape(B, -1))
        feats.append(f)
    x = wav
    for i in range(d["n_scales"]):
        if i > 0:
            x = F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]
        h, f, cin = x[:, None], [], 1
        for j, (k, s) in enumerate(zip(d["msd_kernels"], d["msd_strides"])):
            w, b = _wn(P, f"msd.{i}.layers.{j}.")
            h = lrelu(num.conv1d(h, w, b, stride=s, padding=(k - 1) // 2,
                                 groups=msd_groups(d, j, cin)))
            f.append(h)
            cin = d["msd_channels"][j]
        w, b = _wn(P, f"msd.{i}.post.")
        h = num.conv1d(h, w, b, padding=1)
        f.append(h)
        scores.append(h.reshape(B, -1))
        feats.append(f)
    return scores, feats


# -- log-mel ----------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mels = f / (200.0 / 3)
    log_t = f >= 1000.0
    return np.where(log_t, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                    mels)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                    (200.0 / 3) * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    """librosa's Slaney mel filterbank, area-normalised, [n_mels, n_fft // 2 + 1]."""
    f_max = f_max if f_max and f_max > 0 else sr / 2.0
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    return (fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


def log_mel(wav: torch.Tensor, a: dict, num: Numerics) -> torch.Tensor:
    """[B, N] -> [B, n_mels, frames]: centred STFT with a periodic Hann window
    (reflect padding), magnitude, the filterbank, the floor and the log."""
    n_fft, hop, win = a["n_fft"], a["fft_hop_size"], a["fft_window_size"]
    window = torch.hann_window(win, periodic=True, dtype=torch.float64, device=wav.device)
    if win < n_fft:
        lpad = (n_fft - win) // 2
        window = F.pad(window, (lpad, n_fft - win - lpad))
    spec = torch.stft(wav.float(), n_fft, hop, n_fft, window.float(), center=True,
                      pad_mode="reflect", return_complex=True).abs()
    fb = torch.as_tensor(mel_filterbank(a["input_sampling_rate"], n_fft, a["n_mels"],
                                        a["f_min"], a["f_max"]), device=wav.device)
    return torch.log(torch.clamp(num.matmul(fb, spec), min=LOG_CLIP))


# -- training -------------------------------------------------------------------------------


class AdamW:
    """torch.optim.AdamW's update written out: decoupled decay, then Adam with
    bias correction (eps after the corrected square root)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas, eps: float,
                 weight_decay: float):
        self.params, self.lr, (self.b1, self.b2) = params, lr, betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def learning_rate(tc: dict, update: int) -> float:
    p = np.float32(update) / np.float32(tc["lr_decay_steps"])
    return float(np.float32(tc["learning_rate"]) * np.float32(tc["lr_decay"]) ** p)


def _grads(params, loss):
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: (g if g is not None else torch.zeros_like(p))
            for (k, p), g in zip(params.items(), gs)}


def train_steps(G: dict, D: dict, batches: List[dict], v: dict, d: dict, a: dict, tc: dict,
                num: Numerics) -> dict:
    """One discriminator update then one generator update a batch, from `G`
    and `D` (updated in place): per step the losses, and both optimizers'
    first moments after the first step."""
    opt_g = AdamW(G, learning_rate(tc, 0), (tc["adam_b1"], tc["adam_b2"]), 1e-8, 0.01)
    opt_d = AdamW(D, learning_rate(tc, 0), (tc["adam_b1"], tc["adam_b2"]), 1e-8, 0.01)
    rows, first = [], None
    for i, batch in enumerate(batches):
        lr = learning_rate(tc, i)
        mel, wav = batch["mel"], batch["wav"]
        B = wav.shape[0]
        for p in (*G.values(), *D.values()):
            p.requires_grad_(True)
        fake = generator(G, mel, v, num)
        s_all, _ = discriminators(D, torch.cat([wav, fake.detach()]), d, num)
        d_loss = sum(torch.mean((s[:B] - 1.0) ** 2) + torch.mean(s[B:] ** 2) for s in s_all)
        opt_d.step(_grads(D, d_loss), lr)
        for p in D.values():
            p.requires_grad_(False)
        s_fake, f_fake = discriminators(D, fake, d, num)
        with torch.no_grad():
            _, f_real = discriminators(D, wav, d, num)
            mel_real = log_mel(wav, a, num)
        adv = sum(torch.mean((s - 1.0) ** 2) for s in s_fake)
        fm = sum(torch.mean(torch.abs(fr - ff)) for fl_r, fl_f in zip(f_real, f_fake)
                 for fr, ff in zip(fl_r, fl_f))
        mel_l1 = torch.mean(torch.abs(log_mel(fake, a, num) - mel_real))
        total = adv + tc["fm_weight"] * fm + tc["mel_weight"] * mel_l1
        opt_g.step(_grads(G, total), lr)
        rows.append({"d": float(d_loss.detach()), "g": float(total.detach()), "g_adv": float(adv.detach()),
                     "fm": float(fm.detach()), "mel_l1": float(mel_l1.detach())})
        if i == 0:
            first = {"g": {k: m.clone() for k, m in opt_g.m.items()},
                     "d": {k: m.clone() for k, m in opt_d.m.items()}}
        del fake, s_all, s_fake, f_fake, f_real
    for p in (*G.values(), *D.values()):
        p.requires_grad_(False)
    return {"losses": rows, "first_m": first}
