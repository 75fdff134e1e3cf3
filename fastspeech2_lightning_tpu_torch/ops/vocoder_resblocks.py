"""The HiFiGAN multi-receptive-field (MRF) resblock stage.

    y = mean_j RB_j(x),   RB_j: for each dilation i,
                           x += conv_{k_j,1}(lrelu(conv_{k_j,d_i}(lrelu(x))))

over x [B, T, C] (the JAX package's layout), with SAME padding: positions
outside [0, T) count as zero before every conv.

``fused_mrf_stage`` runs a stage on one of two CUDA kernels (``mrf_route``).
A stage of C <= 16 whose deepest chain reaches at most ``HALO`` rows (every
odd k the gate admits) is one launch of ``mrf_stage`` (``csrc/mrf_stage.cu``,
built for C 8 and 16); the wider stages, and a narrow one of an even k
reaching past the halo, are ``mrf_conv_chain``: one ``mrf_conv`` launch per
conv (``csrc/mrf_conv.cu``, built for C 16, 32, 64 and 128; 18 for a V1
stage). Each wrapper launches its kernel on a CUDA tensor (or raises) and
runs its plain version (``mrf_stage_plain``, ``mrf_conv_reference``) on a
CPU tensor. ``mrf_stage_reference`` is the unfused resblock group written
with ``F.conv1d``, for the CPU and for comparison only. The kernels have no
backward: the wrappers raise a RuntimeError under grad mode when an input
requires grad, on either device, as differentiating the JAX package's
``pallas_call`` fails; the vocoder trainer runs the generator unfused.

The kernels multiply in bf16 on the tensor cores. Their weights are always
bf16 (``prepare_stage_weights``): [K, C, C] for bf16 activations, and for
f32 activations the pair ``split_bf16(w)`` stacked as [2, K, C, C], with
which a kernel forms a_hi w_hi + a_lo w_hi + a_hi w_lo and stays
f32-accurate. A stage runs at the width of the next build that takes it
(``stage_channels``: C 1-8 at 8, 9-16 at 16 on ``mrf_stage``; the per-conv
route at 16, 32, 64 or 128): its weights and biases are padded with zeros
(``prepare_stage_weights``) and its input with zero channels, which stay
zero through the leaky ReLU, the convs and the residuals, so the first C
channels are the stage's exactly.

Replaces ``fastspeech2_lightning_tpu/ops/vocoder_resblocks.py:168
fused_mrf_stage``; the kernels' bounds and designs are in their source
headers.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
HALO = 64  # the JAX kernel's halo: the routing gate's, and mrf_stage's tile margin
STAGE_CHANNELS = (8, 16)  # the widths csrc/mrf_stage.cu is built for
CONV_CHANNELS = (16, 32, 64, 128)  # the widths csrc/mrf_conv.cu is built for
KERNEL_CHANNELS = STAGE_CHANNELS[:1] + CONV_CHANNELS  # every width a stage runs at
STAGE_MAX_PAIRS = 32  # conv pairs (dilations over all resblocks) mrf_stage takes
# the longest conv span (k - 1) * dilation mrf_conv takes: every conv of a
# stage that HALO admits, with an odd k (k 3 at dilation 63)
KERNEL_MAX_SPAN = 126

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p]
)
_STAGE_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# epilogue modes of mrf_conv
WRITE, ACCUMULATE, FINISH = 0, 1, 2


def mrf_stage_supported(C: int, kernel_sizes, dilation_sizes) -> bool:
    """The routing gate of the JAX package (``vocoder_resblocks.py:214-225``):
    the low-channel stages, C <= 128, whose deepest chain's receptive field
    fits the TPU kernel's halo. The CUDA kernels take every such stage
    (``mrf_route``; an odd k keeps each conv's span within
    ``KERNEL_MAX_SPAN``). An even k can pass the halo with a longer span
    (k 2 counts no receptive field at any dilation): such a stage stays
    unfused, where the JAX kernel's rolls would wrap."""
    if C > 128:
        return False
    worst = max(
        sum((k - 1) // 2 * d + (k - 1) // 2 for d in dils)
        for k, dils in zip(kernel_sizes, dilation_sizes)
    )
    if worst > HALO:
        return False
    return all((k - 1) * max(dils) <= KERNEL_MAX_SPAN
               for k, dils in zip(kernel_sizes, dilation_sizes))


def _extent(k: int, d: int) -> int:
    """The larger of a conv's two SAME extents: (k - 1) * d // 2 rows
    before, the rest of its span after."""
    span = (k - 1) * d
    return max(span // 2, span - span // 2)


def stage_reach(kernel_sizes, dilation_sizes) -> int:
    """The deepest chain's one-sided reach: over each resblock's dilations,
    the sum of both convs' SAME extents. For an odd k it is the receptive
    field the gate counts; for an even k it can be more."""
    return max(sum(_extent(k, d) + _extent(k, 1) for d in dils)
               for k, dils in zip(kernel_sizes, dilation_sizes))


def _stage_fits(kernel_sizes, dilation_sizes) -> bool:
    """Whether ``mrf_stage``'s 64-row tile margin holds the stage."""
    return (stage_reach(kernel_sizes, dilation_sizes) <= HALO
            and sum(len(d) for d in dilation_sizes) <= STAGE_MAX_PAIRS)


def mrf_route(C: int, kernel_sizes, dilation_sizes) -> str:
    """How a stage of C channels runs: "unfused" where the gate
    (``mrf_stage_supported``) refuses it; "stage", one ``mrf_stage`` launch,
    at C <= 16 when the deepest chain reaches at most ``HALO`` rows (and it
    has at most ``STAGE_MAX_PAIRS`` dilations); else "conv", one
    ``mrf_conv`` launch a conv."""
    if not mrf_stage_supported(C, kernel_sizes, dilation_sizes):
        return "unfused"
    if C <= STAGE_CHANNELS[-1] and _stage_fits(kernel_sizes, dilation_sizes):
        return "stage"
    return "conv"


def _next_width(C: int, widths) -> int:
    for width in widths:
        if C <= width:
            return width
    raise ValueError(f"the MRF kernel takes C <= {widths[-1]}, got {C}")


def kernel_channels(C: int) -> int:
    """The least of ``KERNEL_CHANNELS`` that holds C (C 1-8 at 8, 96 at
    128): the width a stage of C channels runs at, but for a narrow stage
    on the per-conv route, which runs at 16 (``stage_channels``)."""
    return _next_width(C, KERNEL_CHANNELS)


def conv_channels(C: int) -> int:
    """The width ``mrf_conv`` runs C channels at: the least of
    ``CONV_CHANNELS`` that holds C (C 8 at 16)."""
    return _next_width(C, CONV_CHANNELS)


def stage_channels(C: int, kernel_sizes, dilation_sizes) -> int:
    """The width a stage of C channels runs at: ``kernel_channels(C)`` on
    the "stage" route, ``conv_channels(C)`` on the "conv" route."""
    if mrf_route(C, kernel_sizes, dilation_sizes) == "stage":
        return kernel_channels(C)
    return conv_channels(C)


def _pad_channels(t: torch.Tensor, width: int, dims: int) -> torch.Tensor:
    """`t` with its last `dims` axes zero-padded at the end to `width`."""
    pad = []
    for size in reversed(t.shape[t.dim() - dims:]):
        pad += [0, width - size]
    return F.pad(t, pad) if any(pad) else t


def split_bf16(w: torch.Tensor) -> torch.Tensor:
    """An f32 tensor as two bf16 parts stacked on a new first axis: hi = w
    rounded to bf16 and lo = (w - hi) rounded to bf16, so that hi + lo equals
    w to a relative 2^-16."""
    w = w.float()
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    return torch.stack([hi, lo])


def prepare_stage_weights(
    stage_params: Sequence[Dict[str, torch.Tensor]],
    kernel_sizes: Sequence[int],
    dilation_sizes: Sequence[Sequence[int]],
    dtype: torch.dtype,
) -> List[torch.Tensor]:
    """Flatten one stage's resblocks, given in torch Conv1d layout
    (``convs1.{i}.weight`` [C, C, k], ``convs1.{i}.bias`` [C], ...), into
    the kernels' order: for each resblock j, for each dilation i:
    W1, b1, W2, b2, contiguous, at the stage's width Cp =
    ``stage_channels(C, ...)`` (zero rows, columns and biases past C). For
    activations of `dtype` bf16 a W is bf16 [k, Cp, Cp] (tap, in, out); for
    f32 it is ``split_bf16`` of that, bf16 [2, k, Cp, Cp]. The biases are
    [Cp] in `dtype`."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"prepare_stage_weights: dtype {dtype} not supported")
    width = stage_channels(stage_params[0]["convs1.0.bias"].shape[0], kernel_sizes,
                           dilation_sizes)
    flat: List[torch.Tensor] = []
    for j, dils in enumerate(dilation_sizes):
        p = stage_params[j]
        for i in range(len(dils)):
            for name in (f"convs1.{i}", f"convs2.{i}"):
                w = p[f"{name}.weight"].permute(2, 1, 0)  # [Cout, Cin, k] -> (tap, in, out)
                w = _pad_channels(w, width, 2)
                if dtype == torch.float32:
                    flat.append(split_bf16(w).contiguous())
                else:
                    flat.append(w.contiguous().to(torch.bfloat16))
                flat.append(_pad_channels(p[f"{name}.bias"], width, 1).contiguous().to(dtype))
    return flat


def _whole_weight(w: torch.Tensor) -> torch.Tensor:
    """[K, C, C] f32 from a prepared weight: [K, C, C], or the (hi, lo) pair
    [2, K, C, C], whose sum is exact in f32."""
    return w.float().sum(0) if w.dim() == 4 else w.float()


def mrf_conv_reference(
    x, w, bias, dilation: int, residual=None, out=None, acc=None,
    mode: int = WRITE, scale: float = 1.0,
):
    """Plain version of one ``mrf_conv``: y = bias + conv(lrelu(x)) [+ res],
    then the epilogue `mode` into `out` / `acc`, computed in f32. `w` as
    ``prepare_stage_weights`` gives it, or [K, C, C] in any float type; of
    weights and bias padded past x's C only the first C channels count."""
    C = x.shape[-1]
    xt = F.leaky_relu(x.float(), LRELU_SLOPE).transpose(1, 2)
    y = F.conv1d(
        xt, _whole_weight(w)[:, :C, :C].permute(2, 1, 0), bias.float()[:C],
        padding="same", dilation=dilation,
    ).transpose(1, 2)
    if residual is not None:
        y = y + residual.float()
    if mode == WRITE:
        out.copy_(y)
    elif mode == ACCUMULATE:
        acc.add_(y, alpha=scale)
    else:
        out.copy_(acc + scale * y)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share memory."""
    if a.device != b.device or a.numel() == 0 or b.numel() == 0:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _refuse_autograd(name: str, *tensors) -> None:
    """The MRF kernel has no backward (as the JAX package's ``pallas_call``
    has no VJP): under grad mode with an input that requires grad it would
    return outputs without a ``grad_fn`` and train nothing, so it raises."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the MRF kernel has no backward; call it under torch.no_grad() or "
            "torch.inference_mode(), or run the generator with fused=False to train it")


def mrf_conv(
    x, w, bias, dilation: int, residual=None, out=None, acc=None,
    mode: int = WRITE, scale: float = 1.0,
) -> None:
    """One conv of the stage with its epilogue, in place into `out` / `acc`:
    y = bias + sum_tap lrelu(x shifted by (tap - half) * dilation) @ w[tap]
    [+ residual]; WRITE: out = y; ACCUMULATE: acc += scale * y; FINISH:
    out = acc + scale * y, with SAME padding. x, residual, out: [B, T, C]
    contiguous, C <= 128; w as ``prepare_stage_weights`` gives it for x's
    dtype (bf16 [K, Cp, Cp], or [2, K, Cp, Cp] for f32 x, at Cp =
    ``conv_channels(C)``), (K - 1) * dilation <= 126; bias [Cp]; acc
    [B, T, C] f32. At C < Cp the operands are copied to Cp channels and
    back (``_mrf_conv_padded``); that per-call path is for direct callers of
    one conv only: ``fused_mrf_stage``, the port's one caller, pads a
    stage's input once and calls this at Cp. `residual`
    may be `out`; `x` may not (a block of the kernel reads rows its
    neighbours write)."""
    _refuse_autograd("mrf_conv", x, w, bias, residual)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mrf_conv: unsupported device {x.device}")
    if out is not None and _overlap(x, out):
        raise ValueError("mrf_conv: `x` must not alias `out`")
    if x.device.type == "cpu":
        mrf_conv_reference(x, w, bias, dilation, residual, out, acc, mode, scale)
        return
    B, T, C = x.shape
    K = w.shape[-3]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"mrf_conv: dtype {x.dtype} not supported")
    width = conv_channels(C)
    if C != width and w.shape[-1] == width:
        _mrf_conv_padded(x, w, bias, dilation, residual, out, acc, mode, scale)
        return
    if C not in CONV_CHANNELS:
        raise ValueError(f"mrf_conv: C={C} not in {CONV_CHANNELS}")
    if dilation < 1 or (K - 1) * dilation > KERNEL_MAX_SPAN:
        raise ValueError(f"mrf_conv: kernel size {K} with dilation {dilation} not supported: "
                         f"(K - 1) * dilation must be at most {KERNEL_MAX_SPAN}")
    want_w = (2, K, C, C) if x.dtype == torch.float32 else (K, C, C)
    if w.shape != want_w or w.dtype != torch.bfloat16 or bias.shape != (C,):
        raise ValueError(
            f"mrf_conv: weights {w.dtype} {tuple(w.shape)}/{tuple(bias.shape)}: want bf16 "
            f"{want_w} (prepare_stage_weights) and [{C}] for {x.dtype} x")
    if w.device != x.device or not w.is_contiguous():
        raise ValueError(f"mrf_conv: w must be contiguous on {x.device}")
    tensors = {"x": x, "bias": bias, "residual": residual, "out": out}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"mrf_conv: {name} must be contiguous {x.dtype} on {x.device}")
    for name, t in (("residual", residual), ("out", out), ("acc", acc)):
        if t is not None and t.shape != x.shape:
            raise ValueError(f"mrf_conv: {name} must be [B, T, C] = {tuple(x.shape)}")
    if mode != ACCUMULATE and out is None:
        raise ValueError("mrf_conv: this mode writes `out`")
    if mode != WRITE:
        if acc is None or acc.dtype != torch.float32 or not acc.is_contiguous():
            raise ValueError("mrf_conv: this mode needs a contiguous f32 `acc`")

    from ..kernels import build

    lib = build.load("mrf_conv", {"mrf_conv": _ARGTYPES})
    err = build.launch(
        x.device, lib.mrf_conv, _DTYPE_CODES[x.dtype],
        x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        out.data_ptr() if out is not None else None,
        acc.data_ptr() if acc is not None else None,
        B, T, C, K, dilation, mode, scale,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "mrf_conv")
    build.count(mrf_conv)


mrf_conv.launches = 0


def _mrf_conv_padded(x, w, bias, dilation, residual, out, acc, mode, scale) -> None:
    """``mrf_conv`` of x [B, T, C] with weights prepared at the kernel's
    width: the operands padded with zero channels, one launch, the first C
    channels copied back into `out` / `acc`. For a direct caller of one
    conv; ``fused_mrf_stage`` never reaches it."""
    width = w.shape[-1]
    x_p = _pad_channels(x, width, 1).contiguous()
    res_p = None if residual is None else _pad_channels(residual, width, 1).contiguous()
    out_p = None if out is None else x_p.new_empty(x_p.shape)
    acc_p = None if acc is None else _pad_channels(acc, width, 1).contiguous()
    mrf_conv(x_p, w, bias, dilation, res_p, out_p, acc_p, mode, scale)
    if out_p is not None and mode != ACCUMULATE:
        out.copy_(out_p[..., : x.shape[-1]])
    if acc_p is not None and mode == ACCUMULATE:
        acc.copy_(acc_p[..., : x.shape[-1]])


def mrf_stage_plain(
    x: torch.Tensor,
    flat_weights: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
) -> torch.Tensor:
    """Plain version of ``mrf_stage``: the stage as ``mrf_conv_reference``
    calls on the prepared weights (the f32 sum of a split pair), x and
    every intermediate in f32, the result in x's dtype. Of weights padded
    past x's C only the first C channels count."""
    xf = x.float()
    acc = torch.zeros_like(xf)
    pos = 0
    for dils in dilation_sizes:
        s = xf
        for d in dils:
            w1, b1, w2, b2 = flat_weights[pos : pos + 4]
            pos += 4
            t, s_next = torch.empty_like(xf), torch.empty_like(xf)
            mrf_conv_reference(s, w1, b1, d, out=t)
            mrf_conv_reference(t, w2, b2, 1, residual=s, out=s_next)
            s = s_next
        acc += s
    return (acc / len(kernel_sizes)).to(x.dtype)


def mrf_stage(
    x: torch.Tensor,
    flat_weights: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
) -> torch.Tensor:
    """A whole stage in one launch of ``csrc/mrf_stage.cu``: x [B, T, C]
    contiguous, C 8 or 16, f32 or bf16 -> y [B, T, C] in x's dtype, with
    `flat_weights` as ``prepare_stage_weights`` gives them at C (bf16
    [k, C, C], or [2, k, C, C] for f32 x; biases [C] in x's dtype). Takes a
    stage whose deepest chain reaches at most ``HALO`` rows
    (``stage_reach``) over at most ``STAGE_MAX_PAIRS`` dilations. On a CPU
    tensor it runs ``mrf_stage_plain``. Raises under autograd
    (``_refuse_autograd``) and on anything the kernel does not take."""
    _refuse_autograd("mrf_stage", x, *flat_weights)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mrf_stage: unsupported device {x.device}")
    if x.device.type == "cpu":
        return mrf_stage_plain(x, flat_weights, kernel_sizes, dilation_sizes)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"mrf_stage: dtype {x.dtype} not supported")
    if x.dim() != 3 or x.shape[-1] not in STAGE_CHANNELS or not x.is_contiguous():
        raise ValueError(f"mrf_stage: x must be a contiguous [B, T, C] with C in "
                         f"{STAGE_CHANNELS}, got {tuple(x.shape)}")
    B, T, C = x.shape
    if not 1 <= B <= 65535 or T < 1:
        raise ValueError(f"mrf_stage: B {B}, T {T} not supported (1 <= B <= 65535, T >= 1)")
    if len(kernel_sizes) != len(dilation_sizes) or not _stage_fits(kernel_sizes, dilation_sizes):
        raise ValueError(
            f"mrf_stage: kernel sizes {tuple(kernel_sizes)} with dilations "
            f"{tuple(map(tuple, dilation_sizes))}: the deepest chain must reach at most {HALO} "
            f"rows over at most {STAGE_MAX_PAIRS} dilations")
    ks = [k for k, dils in zip(kernel_sizes, dilation_sizes) for _ in dils]
    if len(flat_weights) != 4 * len(ks):
        raise ValueError(f"mrf_stage: {len(flat_weights)} weights for {len(ks)} conv pairs")
    for i, (w, bias) in enumerate(zip(flat_weights[0::2], flat_weights[1::2])):
        k = ks[i // 2]
        want_w = (2, k, C, C) if x.dtype == torch.float32 else (k, C, C)
        if w.shape != want_w or w.dtype != torch.bfloat16 or bias.shape != (C,) \
                or bias.dtype != x.dtype:
            raise ValueError(
                f"mrf_stage: conv {i} weights {w.dtype} {tuple(w.shape)}, bias {bias.dtype} "
                f"{tuple(bias.shape)}: want bf16 {want_w} (prepare_stage_weights) and "
                f"{x.dtype} [{C}] for {x.dtype} x")
        if w.device != x.device or bias.device != x.device or not w.is_contiguous() \
                or not bias.is_contiguous():
            raise ValueError(f"mrf_stage: conv {i}'s weights must be contiguous on {x.device}")
    y = torch.empty_like(x)

    from ..kernels import build

    lib = build.load("mrf_stage", {"mrf_stage": _STAGE_ARGTYPES})
    n = len(flat_weights) // 2
    err = build.launch(
        x.device, lib.mrf_stage, _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
        (ctypes.c_void_p * n)(*(w.data_ptr() for w in flat_weights[0::2])),
        (ctypes.c_void_p * n)(*(b.data_ptr() for b in flat_weights[1::2])),
        (ctypes.c_int * len(kernel_sizes))(*kernel_sizes),
        (ctypes.c_int * len(dilation_sizes))(*(len(d) for d in dilation_sizes)),
        (ctypes.c_int * len(ks))(*(d for dils in dilation_sizes for d in dils)),
        len(kernel_sizes), B, T, C, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "mrf_stage")
    build.count(mrf_stage)
    return y


mrf_stage.launches = 0


def mrf_conv_chain(
    x: torch.Tensor,
    flat_weights: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
) -> torch.Tensor:
    """A whole stage as one ``mrf_conv`` per conv (18 for a V1 stage), x
    [B, T, C] contiguous at the weights' width. Buffers: t (the inner
    conv's output), s (the running resblock state, updated in place) and an
    f32 accumulator of the resblock average, which the last conv of the
    last resblock writes out."""
    t = torch.empty_like(x)
    s_buf = torch.empty_like(x)
    out = torch.empty_like(x)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    n = len(kernel_sizes)
    scale = 1.0 / n
    pos = 0
    for j, dils in enumerate(dilation_sizes):
        s = x
        for i, d in enumerate(dils):
            w1, b1, w2, b2 = flat_weights[pos : pos + 4]
            pos += 4
            mrf_conv(s, w1, b1, d, out=t)
            if i < len(dils) - 1:
                mrf_conv(t, w2, b2, 1, residual=s, out=s_buf)
                s = s_buf
            elif j < n - 1:
                mrf_conv(t, w2, b2, 1, residual=s, acc=acc, mode=ACCUMULATE, scale=scale)
            else:
                mrf_conv(t, w2, b2, 1, residual=s, out=out, acc=acc, mode=FINISH,
                         scale=scale)
    return out


def fused_mrf_stage(
    x: torch.Tensor,
    flat_weights: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
) -> torch.Tensor:
    """A whole stage, x [B, T, C] -> mean_j RB_j(x) [B, T, C], with
    `flat_weights` from ``prepare_stage_weights``: one ``mrf_stage`` launch
    where the weights' width is one of ``STAGE_CHANNELS`` and the stage fits
    its tile margin, else ``mrf_conv_chain``. Below the weights' width
    (C 12 runs at 16) x is padded with zero channels once and the result
    sliced back. Raises under autograd (``_refuse_autograd``)."""
    _refuse_autograd("fused_mrf_stage", x, *flat_weights)
    C = x.shape[-1]
    width = flat_weights[1].shape[0]
    if C < width:
        return fused_mrf_stage(_pad_channels(x, width, 1), flat_weights, kernel_sizes,
                               dilation_sizes)[..., :C]
    x = x.contiguous()
    if width in STAGE_CHANNELS and _stage_fits(kernel_sizes, dilation_sizes):
        return mrf_stage(x, flat_weights, kernel_sizes, dilation_sizes)
    return mrf_conv_chain(x, flat_weights, kernel_sizes, dilation_sizes)


def mrf_stage_reference(
    x: torch.Tensor,
    stage_params: Sequence[Dict[str, torch.Tensor]],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
) -> torch.Tensor:
    """Plain version of a stage: the unfused resblock group with F.conv1d,
    in x's dtype, over x [B, T, C] and torch-layout resblock params."""
    h = x.transpose(1, 2)
    acc = None
    for j, dils in enumerate(dilation_sizes):
        p = stage_params[j]
        s = h
        for i, d in enumerate(dils):
            r = F.leaky_relu(s, LRELU_SLOPE)
            r = F.conv1d(r, p[f"convs1.{i}.weight"].to(h.dtype),
                         p[f"convs1.{i}.bias"].to(h.dtype), padding="same", dilation=d)
            r = F.leaky_relu(r, LRELU_SLOPE)
            r = F.conv1d(r, p[f"convs2.{i}.weight"].to(h.dtype),
                         p[f"convs2.{i}.bias"].to(h.dtype), padding="same")
            s = s + r
        acc = s if acc is None else acc + s
    return (acc / len(kernel_sizes)).transpose(1, 2)
