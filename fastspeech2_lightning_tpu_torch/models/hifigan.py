"""HiFiGAN generator, inference only (counterpart of the JAX package's
``models/hifigan.py``).

Parameters are a torch HiFiGAN state_dict (``conv_pre``, ``ups.{i}``,
``resblocks.{r}.convs1.{k}`` ..., ``conv_post``) with weight norm folded.
``conv_pre``, the upsampling transposed convs and ``conv_post`` run as
``F.conv1d`` / ``F.conv_transpose1d``, as the JAX package leaves them to
XLA. With ``fused=True`` every resblock-1 stage that passes
``mrf_stage_supported`` and has at least 256 frames runs through the MRF
kernel (``ops/vocoder_resblocks.py``), the gate of ``hifigan.py:249-254``.
Activations are [B, C, T] here and [B, T, C] inside the fused stage.

``init_random_hifigan`` draws the JAX package's random generator weights
(the same numpy draws in the same order); ``HiFiGANGenerator`` holds them as
``nn.Parameter``s under the state_dict names, for the vocoder trainer.
``make_parallel_vocoder_fn`` vocodes over one process's replicas: rows
apart when there are enough of them, else the frame axis in windows."""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import hifigan_state_from_jax
from ..device import resolve_device
from ..ops.vocoder_resblocks import (
    fused_mrf_stage,
    mrf_stage_supported,
    prepare_stage_weights,
)

LRELU_SLOPE = 0.1


@dataclasses.dataclass
class HiFiGANConfig:
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    n_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256

    @property
    def total_upsampling(self) -> int:
        return int(np.prod(self.upsample_rates))

    @property
    def receptive_margin_frames(self) -> int:
        """One-sided receptive field of the generator in mel frames (ceil);
        a copy of the JAX package's ``HiFiGANConfig.receptive_margin_frames``."""
        rate = 1.0  # output samples per mel frame at the current depth
        margin = 3.0  # conv_pre k=7 -> (7-1)/2 frames
        for u, k in zip(self.upsample_rates, self.upsample_kernel_sizes):
            p = (k - u) // 2
            margin += math.ceil(max(p, k - 1 - p) / u) / rate
            rate *= u
            reach = 0
            for rk, dils in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                half = (rk - 1) // 2
                if self.resblock == "1":
                    r = sum(half * d + half for d in dils)
                else:
                    r = sum(half * d for d in dils)
                reach = max(reach, r)
            margin += reach / rate
        margin += 3.0 / rate  # conv_post k=7
        return int(math.ceil(margin))


def _resblock(x, params, prefix: str, resblock: str, dilations):
    for i, d in enumerate(dilations):
        if resblock == "1":
            xt = F.leaky_relu(x, LRELU_SLOPE)
            xt = F.conv1d(xt, params[f"{prefix}.convs1.{i}.weight"],
                          params[f"{prefix}.convs1.{i}.bias"], padding="same", dilation=d)
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            xt = F.conv1d(xt, params[f"{prefix}.convs2.{i}.weight"],
                          params[f"{prefix}.convs2.{i}.bias"], padding="same")
        else:
            xt = F.leaky_relu(x, LRELU_SLOPE)
            xt = F.conv1d(xt, params[f"{prefix}.convs.{i}.weight"],
                          params[f"{prefix}.convs.{i}.bias"], padding="same", dilation=d)
        x = x + xt
    return x


def stage_params(params: Dict[str, torch.Tensor], stage: int, n_blocks: int):
    """The resblock params of upsample stage `stage`, one dict per resblock
    with keys relative to ``resblocks.{r}.``."""
    out = []
    for j in range(n_blocks):
        prefix = f"resblocks.{stage * n_blocks + j}."
        out.append({k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)})
    return out


def hifigan_generator(
    params: Dict[str, torch.Tensor],
    mel: torch.Tensor,
    config: HiFiGANConfig,
    fused: bool = False,
    stage_weights: Optional[Dict[int, list]] = None,
) -> torch.Tensor:
    """mel [B, T, n_mels] -> wav [B, T * total_upsampling]. `stage_weights`
    holds ``prepare_stage_weights`` per fused stage (built here if absent)."""
    ks = tuple(config.resblock_kernel_sizes)
    dils = tuple(tuple(d) for d in config.resblock_dilation_sizes)
    n = len(ks)
    x = F.conv1d(mel.transpose(1, 2), params["conv_pre.weight"], params["conv_pre.bias"],
                 padding="same")
    for i, (u, k) in enumerate(zip(config.upsample_rates, config.upsample_kernel_sizes)):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = F.conv_transpose1d(x, params[f"ups.{i}.weight"], params[f"ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        C, T = x.shape[1], x.shape[2]
        if fused and config.resblock == "1" and mrf_stage_supported(C, ks, dils) and T >= 256:
            flat = (stage_weights or {}).get(i)
            if flat is None:
                flat = prepare_stage_weights(stage_params(params, i, n), ks, dils, x.dtype)
            x = fused_mrf_stage(x.transpose(1, 2), flat, ks, dils).transpose(1, 2)
        else:
            acc = None
            for j in range(n):
                out = _resblock(x, params, f"resblocks.{i * n + j}", config.resblock, dils[j])
                acc = out if acc is None else acc + out
            x = acc / n
    x = F.leaky_relu(x, LRELU_SLOPE)
    x = F.conv1d(x, params["conv_post.weight"], params["conv_post.bias"], padding="same")
    return torch.tanh(x)[:, 0, :]


def init_random_hifigan(config: HiFiGANConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random generator weights as a state_dict of numpy f32 arrays: the
    draws of the JAX package's ``init_random_hifigan`` (``hifigan.py:
    276-311``; one ``np.random.default_rng(seed)``, N(0, 0.02^2) weights in
    its order, zero biases), so a seed gives the JAX package's weights bit
    for bit, in the torch layout."""
    rng = np.random.default_rng(seed)

    def w(k, cin, cout):
        return rng.standard_normal((k, cin, cout)).astype(np.float32) * 0.02

    params: Dict[str, object] = {}
    ch = config.upsample_initial_channel
    params["conv_pre_w"], params["conv_pre_b"] = w(7, config.n_mels, ch), np.zeros(ch)
    for i, k in enumerate(config.upsample_kernel_sizes):
        cout = ch // 2
        params[f"up_{i}_w"], params[f"up_{i}_b"] = w(k, ch, cout), np.zeros(cout)
        for j, (rk, dil) in enumerate(zip(config.resblock_kernel_sizes,
                                          config.resblock_dilation_sizes)):
            block = {}
            for di in range(len(dil)):
                for name in ("convs1", "convs2"):
                    block[f"{name}_{di}_w"] = w(rk, cout, cout)
                    block[f"{name}_{di}_b"] = np.zeros(cout)
            params[f"res_{i}_{j}"] = block
        ch = cout
    params["conv_post_w"], params["conv_post_b"] = w(7, ch, 1), np.zeros(1)
    return hifigan_state_from_jax(params, config)


class _Conv(nn.Module):
    def __init__(self, weight: np.ndarray, bias: np.ndarray, device):
        super().__init__()
        self.weight = nn.Parameter(torch.as_tensor(np.asarray(weight, np.float32), device=device))
        self.bias = nn.Parameter(torch.as_tensor(np.asarray(bias, np.float32), device=device))


class _ResBlock(nn.Module):
    def __init__(self, sd: Dict[str, np.ndarray], prefix: str, names, n: int, device):
        super().__init__()
        for name in names:
            setattr(self, name, nn.ModuleList(
                _Conv(sd[f"{prefix}.{name}.{d}.weight"], sd[f"{prefix}.{name}.{d}.bias"], device)
                for d in range(n)))


class HiFiGANGenerator(nn.Module):
    """The generator as trainable parameters, named as its state_dict
    (``conv_pre``, ``ups.{i}``, ``resblocks.{r}.convs1.{k}`` ..., ``conv_post``),
    f32 on `device`. The forward runs ``hifigan_generator`` unfused (the MRF
    kernel has no backward) with every parameter cast to `dtype` and returns
    the wav in f32: the JAX trainer's ``g_forward`` (``vocoder.py:103-105``)."""

    def __init__(self, config: HiFiGANConfig, state_dict: Dict[str, np.ndarray], device=None):
        super().__init__()
        self.config = config
        self.conv_pre = _Conv(state_dict["conv_pre.weight"], state_dict["conv_pre.bias"], device)
        self.ups = nn.ModuleList(_Conv(state_dict[f"ups.{i}.weight"], state_dict[f"ups.{i}.bias"],
                                       device) for i in range(len(config.upsample_rates)))
        names = ("convs1", "convs2") if config.resblock == "1" else ("convs",)
        n = len(config.resblock_kernel_sizes)
        self.resblocks = nn.ModuleList(
            _ResBlock(state_dict, f"resblocks.{r}", names,
                      len(config.resblock_dilation_sizes[r % n]), device)
            for r in range(len(config.upsample_rates) * n))
        self.conv_post = _Conv(state_dict["conv_post.weight"], state_dict["conv_post.bias"],
                               device)

    def forward(self, mel: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """mel [B, T, n_mels] -> wav [B, T * hop] f32."""
        params = {k: p.to(dtype) for k, p in self.named_parameters()}
        return hifigan_generator(params, mel.to(dtype), self.config, fused=False).float()


def _fold_weight_norm(sd: dict, prefix: str) -> Optional[np.ndarray]:
    """The conv weight for `prefix` from a torch state_dict: a plain
    ``.weight`` or a folded weight-norm pair (``hifigan.py:314-330``)."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    for g_key, v_key in (
        (f"{prefix}.weight_g", f"{prefix}.weight_v"),
        (f"{prefix}.parametrizations.weight.original0",
         f"{prefix}.parametrizations.weight.original1"),
    ):
        if v_key in sd:
            v = np.asarray(sd[v_key])
            g = np.asarray(sd[g_key])
            norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    return None


def _torch_generator_state(sd: dict, config: HiFiGANConfig) -> Dict[str, np.ndarray]:
    """A canonical torch HiFiGAN state_dict (raw, or under a 'generator.'
    prefix; weight norm folded) -> the generator's plain state_dict."""
    if not any(k.startswith("conv_pre") for k in sd):
        for cand in ("generator.", "model.generator.", "g."):
            if any(k.startswith(cand + "conv_pre") for k in sd):
                sd = {k[len(cand):]: v for k, v in sd.items() if k.startswith(cand)}
                break
    out: Dict[str, np.ndarray] = {}

    def take(prefix, bias_len_axis):
        w = _fold_weight_norm(sd, prefix)
        if w is None:
            raise KeyError(f"missing conv weights for {prefix}")
        out[f"{prefix}.weight"] = np.asarray(w, np.float32)
        out[f"{prefix}.bias"] = np.asarray(
            sd.get(f"{prefix}.bias", np.zeros(w.shape[bias_len_axis])), np.float32
        )

    take("conv_pre", 0)
    n = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        take(f"ups.{i}", 1)
        for j in range(n):
            for di in range(len(config.resblock_dilation_sizes[j])):
                names = ("convs1", "convs2") if config.resblock == "1" else ("convs",)
                for name in names:
                    take(f"resblocks.{i * n + j}.{name}.{di}", 0)
    take("conv_post", 0)
    return out


def load_vocoder_params(path) -> Tuple[Dict[str, np.ndarray], HiFiGANConfig, int]:
    """(generator state_dict as numpy, HiFiGANConfig, global_step) from a
    torch/Lightning checkpoint (.ckpt/.pt/.pth) or an .npz of the JAX
    package's parameter pytree (``hifigan.py:415-471``)."""
    path = Path(path)
    global_step = 0
    config = HiFiGANConfig()
    if path.suffix in (".ckpt", ".pt", ".pth"):
        # HiFiGAN training checkpoints pickle their config objects
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            sd = ckpt["state_dict"]
            global_step = int(ckpt.get("global_step", 0))
            hp = ckpt.get("hyper_parameters", {})
            cfg = hp.get("config", {}) if isinstance(hp, dict) else {}
            if isinstance(cfg, dict):
                mdl = cfg.get("model", {})
                audio = cfg.get("preprocessing", {}).get("audio", {})
                config = HiFiGANConfig(
                    resblock=str(mdl.get("resblock", "1")),
                    upsample_rates=tuple(mdl.get("upsample_rates", (8, 8, 2, 2))),
                    upsample_kernel_sizes=tuple(
                        mdl.get("upsample_kernel_sizes", (16, 16, 4, 4))
                    ),
                    upsample_initial_channel=mdl.get("upsample_initial_channel", 512),
                    resblock_kernel_sizes=tuple(mdl.get("resblock_kernel_sizes", (3, 7, 11))),
                    resblock_dilation_sizes=tuple(
                        tuple(d) for d in mdl.get(
                            "resblock_dilation_sizes", ((1, 3, 5), (1, 3, 5), (1, 3, 5))
                        )
                    ),
                    n_mels=audio.get("n_mels", 80),
                    sampling_rate=audio.get("output_sampling_rate", 22050),
                    hop_size=audio.get("fft_hop_size", 256),
                )
        else:
            sd = ckpt.get("generator", ckpt) if isinstance(ckpt, dict) else ckpt
        sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
        params = _torch_generator_state(sd, config)
    elif path.suffix == ".npz":
        loaded = np.load(path, allow_pickle=True)
        if "config" in loaded:
            config = HiFiGANConfig(**loaded["config"].item())
        params = hifigan_state_from_jax(loaded["params"].item(), config)
        global_step = int(loaded["global_step"]) if "global_step" in loaded else 0
    else:
        raise ValueError(f"Unsupported vocoder checkpoint format: {path}")
    return params, config, global_step


def load_vocoder_checkpoint(path, precision: str = "float32", fused: bool = False, device=None):
    """(vocoder_fn, global_step, output_hop_size) from a vocoder checkpoint
    (``hifigan.py:398-412``)."""
    params, config, global_step = load_vocoder_params(path)
    fn = make_vocoder_fn(params, config, precision=precision, fused=fused, device=device)
    return fn, global_step, config.total_upsampling


def make_vocoder_fn(
    params: Dict[str, np.ndarray],
    config: HiFiGANConfig,
    precision: str = "float32",
    fused: bool = False,
    device=None,
):
    """Callable (mel [B, T, n_mels] numpy) -> (wav [B, samples] float32 numpy,
    sample rate), with ``.device_fn`` (mel tensor on the device -> wav tensor),
    ``.device``, ``.sample_rate``, ``.hop`` and ``.receptive_margin_frames``
    (the window margin of ``synthesis.streaming``).
    precision: "float32" or "bfloat16" (weights and activations)."""
    device = resolve_device(device)
    dt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    p = {k: torch.as_tensor(np.asarray(v)).to(device=device, dtype=dt)
         for k, v in params.items()}
    ks = tuple(config.resblock_kernel_sizes)
    dils = tuple(tuple(d) for d in config.resblock_dilation_sizes)
    stage_weights = {}
    if fused and config.resblock == "1":
        ch = config.upsample_initial_channel
        for i in range(len(config.upsample_rates)):
            ch //= 2
            if mrf_stage_supported(ch, ks, dils):
                stage_weights[i] = prepare_stage_weights(
                    stage_params(p, i, len(ks)), ks, dils, dt
                )

    @torch.inference_mode()
    def device_fn(mel_dev: torch.Tensor) -> torch.Tensor:
        return hifigan_generator(p, mel_dev.to(device=device, dtype=dt), config,
                                 fused=fused, stage_weights=stage_weights)

    def vocoder(mel: np.ndarray):
        wav = device_fn(torch.as_tensor(np.asarray(mel)))
        return wav.float().cpu().numpy(), config.sampling_rate

    vocoder.device_fn = device_fn
    vocoder.device = device
    vocoder.sample_rate = config.sampling_rate
    vocoder.hop = config.total_upsampling
    vocoder.receptive_margin_frames = config.receptive_margin_frames
    return vocoder


def make_parallel_vocoder_fn(
    params: Dict[str, np.ndarray],
    config: HiFiGANConfig,
    devices: Sequence,
    precision: str = "float32",
    fused: bool = False,
    replicas=None,
):
    """The vocoder over one process's devices (``hifigan.py:514-629``): a
    callable as ``make_vocoder_fn``'s, with ``.device_fn(mel, n_real=None)``,
    ``.device`` (the first device), ``.sample_rate``, ``.hop``,
    ``.receptive_margin_frames`` and ``._window_cache``, over one
    ``make_vocoder_fn`` a device run by `replicas` (a
    ``parallel.replicas.Replicas`` over `devices`; one is made if None).

    `mel` is a [B, T, n_mels] tensor or a list of one row block a device
    (what each replica of a data-parallel Synthesizer holds); `n_real` is
    the number of real rows, the rest being fill. With at least one real
    row a device, each device vocodes its own rows and nothing crosses
    devices. Otherwise the frame axis is split into N windows of w =
    ceil(T / N) frames, each with the generator's one-sided receptive field
    (``receptive_margin_frames``) of true context on both sides (the
    ``windowed_vocode`` contract): window i emits frames [i w, (i + 1) w),
    the last one [T - w, T) so that its slice stays inside the signal, and
    the head is trimmed to (T - w) * hop samples; the pieces equal vocoding
    the whole mel. A mel too short to split (T <= w + 2 * margin, or fewer
    than two windows) takes one plain call on the first device. Returns
    the first `n_real` rows' wav on the first device. With `fused` the MRF
    kernel runs each replica's supported stages (the JAX function is
    unfused; the output is the same either way)."""
    from ..parallel.replicas import Replicas, concat_rows, to_caller

    devices = [torch.device(d) for d in devices]
    replicas = replicas or Replicas(devices)
    vocs = [make_vocoder_fn(params, config, precision=precision, fused=fused, device=d)
            for d in devices]
    n_dev, dev0 = len(devices), devices[0]
    margin, hop = config.receptive_margin_frames, config.total_upsampling
    cache: Dict[tuple, Optional[tuple]] = {}

    def windows(T: int):
        w = -(-T // n_dev)
        n_eff = -(-T // w)
        W = w + 2 * margin
        if T <= W or n_eff < 2:
            return None
        starts = [i * w for i in range(n_eff - 1)] + [T - w]
        return w, W, [(start, min(max(start - margin, 0), T - W)) for start in starts]

    def run(i: int, mel_i):
        return None if mel_i is None else vocs[i].device_fn(mel_i)

    def device_fn(mel, n_real: Optional[int] = None) -> torch.Tensor:
        blocks = list(mel) if isinstance(mel, (list, tuple)) else None
        rows = sum(int(b.shape[0]) for b in blocks) if blocks else int(mel.shape[0])
        B = int(n_real) if n_real else rows
        T = int((blocks[0] if blocks else mel).shape[1])
        if B >= n_dev:
            if blocks is None or len(blocks) != n_dev:
                whole = mel if blocks is None else concat_rows([to_caller(b, dev0) for b in blocks])
                blocks = [b.to(d) for b, d in zip(torch.tensor_split(whole, n_dev), devices)]
            wavs = replicas.map(run, blocks)
            return torch.cat([to_caller(w, dev0) for w in wavs])[:B]
        if (B, T) not in cache:
            cache[(B, T)] = windows(T)
        plan = cache[(B, T)]
        rows_b = (concat_rows([to_caller(b, dev0) for b in blocks]) if blocks
                  else mel.to(dev0))[:B]
        if plan is None:
            return vocs[0].device_fn(rows_b)
        w, W, spans = plan
        ins = [rows_b[:, lo:lo + W].to(d) for (_, lo), d in zip(spans, devices)]
        wavs = replicas.map(run, ins + [None] * (n_dev - len(ins)))
        segs = [to_caller(wav, dev0)[:, (start - lo) * hop:(start - lo + w) * hop]
                for wav, (start, lo) in zip(wavs, spans)]
        head = torch.cat(segs[:-1], dim=1)[:, :(T - w) * hop]
        return torch.cat([head, segs[-1]], dim=1)

    def vocoder(mel: np.ndarray):
        wav = device_fn(torch.as_tensor(np.asarray(mel)))
        return wav.float().cpu().numpy(), config.sampling_rate

    vocoder.device_fn = device_fn
    vocoder.device = dev0
    vocoder.sample_rate = config.sampling_rate
    vocoder.hop = hop
    vocoder.receptive_margin_frames = margin
    vocoder._window_cache = cache  # which (B, T) were window-split, and how
    return vocoder
