"""Attention with an additive key bias, and with dropout on the attention
probabilities for training.

    O = dropout_p(softmax(sm_scale * Q K^T + key_bias[b, None, :])) V

q, k, v are [B, H, T, dh] (any strides with dh contiguous), key_bias [B, T]
(0 valid, NEG_INF padded). Each wrapper launches its CUDA kernel for CUDA
tensors (or raises) and runs its plain PyTorch version for CPU tensors:

- ``attention_fwd``: ``csrc/attention_fwd.cu``, the eval conformer's
  attention (p = 0) and the training forward (p > 0, optional log-sum-exp
  output). Plain versions: ``attention_reference``,
  ``attention_dropout_reference``. It calls the ``torch.library`` op
  ``fs2t::attention_fwd`` (CUDA implementation: the ctypes launch; CPU
  implementation: the plain version in the kernel's output layout; a fake
  with the kernel's strides; a FLOP formula), so eager serving, the
  training Function, ``benchmark`` and an exported program
  (``synthesis/exported.py``) reach kernel A through one registration at
  the default dropout offsets.
- ``attention_bwd``: ``csrc/attention_bwd.cu``, dQ, dK and dV with the same
  dropout mask regenerated. Plain version: autograd through
  ``attention_dropout_reference``. A ctypes wrapper (no exported or counted
  path needs it as an op yet).
- ``attention_with_dropout``: the training entry, a ``torch.autograd.Function``
  over the two kernels on the card (A through the op at the default dropout
  offsets, by its ctypes launch ``_launch_fwd`` at a distributed rank's
  others); on the CPU autograd runs through the plain version.

The kernels are built for head dims 64, 128, 192 and 256
(``KERNEL_HEAD_DIMS``) and for every multiple of 128 above 256, where they
stream the products over the full dh (``csrc/attention_common.cuh``
wide_dh): A in bf16 up to 768 in one block that computes each score once
for all its output columns, above that and in A′ in groups of at most 256
columns (``fwd_column_groups``, ``bwd_column_groups``). Every
other dh runs at the next of them (``kernel_head_dim``): up to 256 the
next build, above it the next multiple of 128, as the JAX package pads dh
(``attention_dropout.py:222-247``). The wrappers zero-pad q, k, v (and o,
dO) with zero columns and slice o, dQ, dK and dV back. Zero columns add
nothing to Q K^T and give zero output columns, so this is exact; the log-sum-
exp is unchanged, `sm_scale` stays the caller's (from the true dh) and the
dropout mask does not depend on dh. A launch is counted once and the FLOP
counts take the true dh.

The dtype picks the kernel inside each source: bf16 tensors go to the
tensor-core kernels, f32 tensors to the CUDA-core f32 kernels (which the f32
card-vs-CPU checks hold to rel-L2 1e-5). bf16 q, k, v (and dO) need rows on
16-byte boundaries (the fused [B, T, 3, H, dh] projection's views have them);
the wrappers raise otherwise. Both kernels skip key tiles past ``kv_end``
(one past each item's last unmasked key), which a pre-pass kernel of the same
C entry computes on the device.

The dropout mask is a pure function of (seed, (b + row_offset) * heads_total
+ h + head_offset, query row, key column): ``dropout_keep_mask`` computes it
in int64 tensors exactly as ``csrc/common.cuh`` does in 32-bit arithmetic, so
the kernels and their plain versions agree at p > 0 element for element.
The hash keys on the full (query row, key column): the low 16 bits of each
packed into one word, and a mix of their high 16 bits that is 0 below
65536, so T is not bounded and a mask at T <= 65536 is the one the low
packing alone draws. The offsets place a data rank's rows and a model rank's heads in the global
batch of a distributed step (``models/conformer.py``), so each rank draws
the block of the one-process mask that its rows and heads cover; the
defaults (0, 0, H) are the mask of one process. They reach the kernels only
on the training launch path (``attention_with_dropout``, ``attention_bwd``):
the op ``fs2t::attention_fwd`` keeps its schema and draws the default mask.
The JAX package draws its mask from the TPU's hardware generator, so the
two packages agree in distribution only. The kernels replace
``ops/attention_dropout.py`` (rows 1-5 of PERF.md's kernel table) and the
library flash attention of the JAX eval conformer
(``models/conformer.py:142``); their bounds and designs are in the CUDA
sources' headers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ..kernels import build

NEG_INF = -1e9

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128, 192, 256)  # the widths csrc/attention_*.cu are built for
_M32 = 0xFFFFFFFF


def attention_fwd_flops(B: int, H: int, T: int, dh: int) -> int:
    """The floating-point operations the plain forward multiplies: Q K^T
    and P V, each 2 B H T T dh, over every [T, T] entry (the key tiles a
    kernel skips included), so the count is the same whatever computes it.
    It is the FLOP formula of the op ``fs2t::attention_fwd``, which
    ``torch.utils.flop_counter.FlopCounterMode`` counts once a call on either
    device."""
    return 4 * B * H * T * T * dh


def attention_bwd_flops(B: int, H: int, T: int, dh: int) -> int:
    """The plain backward's products (autograd through the plain forward):
    the forward's two, and dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q.
    ``FlopCounterMode`` cannot see A′'s ctypes launch, so the wrapper adds
    them to ``attention_bwd.flops`` where it launches the kernel and
    ``utils.benchmarking.count_flops`` adds that counter's change."""
    return 12 * B * H * T * T * dh


def kernel_head_dim(dh: int) -> int:
    """The head dim the kernels run dh at: the least of ``KERNEL_HEAD_DIMS``
    that holds it, and above 256 the next multiple of 128 (``_round_up_128``
    of the JAX package)."""
    if dh <= 0:
        raise ValueError(f"attention kernels take head dims of 1 or more, got {dh}")
    for width in KERNEL_HEAD_DIMS:
        if dh <= width:
            return width
    return -(-dh // 128) * 128


def _kernel_takes(dh: int) -> bool:
    """Whether the kernels run dh as it is (no padding step)."""
    return dh in KERNEL_HEAD_DIMS or (dh > KERNEL_HEAD_DIMS[-1] and dh % 128 == 0)


def _pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """[..., dh] -> [..., width], contiguous, zero columns past dh."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


def padded_fwd(launch, q, k, v, *args):
    """``launch(q, k, v, *args) -> (o, lse)`` run at the kernels' width: for
    a dh they are not built for, q, k and v zero-padded to
    ``kernel_head_dim(dh)`` and o sliced back into q's [B, H, T, dh] in the
    op's [B, T, H, dh] layout; lse as it comes. Kernel A's padding step (the
    tests compose it with the plain version)."""
    dh = q.shape[-1]
    width = kernel_head_dim(dh)
    if width == dh:
        return launch(q, k, v, *args)
    _same_shape("attention_fwd", q, k, v)
    o_p, lse = launch(*(_pad_head_dim(t, width) for t in (q, k, v)), *args)
    o = _out_like(q)
    o.copy_(o_p[..., :dh])
    return o, lse


def padded_bwd(launch, q, k, v, o, do, *args):
    """``launch(q, k, v, o, do, *args) -> (dQ, dK, dV)`` run at the kernels'
    width: q, k, v, o and dO zero-padded as in ``padded_fwd`` and the
    gradients sliced back to [B, H, T, dh], contiguous. Kernel A′'s padding
    step."""
    dh = q.shape[-1]
    width = kernel_head_dim(dh)
    if width == dh:
        return launch(q, k, v, o, do, *args)
    _same_shape("attention_bwd", q, k, v)
    grads = launch(*(_pad_head_dim(t, width) for t in (q, k, v, o, do)), *args)
    return tuple(g[..., :dh].contiguous() for g in grads)


def attention_reference(q, k, v, key_bias, sm_scale: float) -> torch.Tensor:
    """Plain version at p = 0: f32 scores, softmax, probabilities cast to the
    input dtype, then P V (the JAX einsum path, ``conformer.py:177-186``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def dropout_threshold(p: float) -> int:
    """keep iff the 32 hash bits >= this (``attention_dropout.py:39-44``)."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"attention dropout p={p} must lie in [0, 1)")
    return min(int(p * (1 << 32)), (1 << 32) - 1)


def _mul32(x, c: int):
    """x * c mod 2^32 for 0 <= x < 2^32, with every product below 2^49."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _offsets(H: int, row_offset: int, head_offset: int, heads_total: Optional[int]):
    """(row_offset, head_offset, heads_total) with the default heads_total H,
    checked to place H heads."""
    heads_total = H if heads_total is None else int(heads_total)
    if row_offset < 0 or head_offset < 0 or head_offset + H > heads_total:
        raise ValueError(f"dropout offsets ({row_offset}, {head_offset}, {heads_total}) do "
                         f"not place {H} heads")
    return int(row_offset), int(head_offset), heads_total


def _stream_index(B: int, H: int, row_offset: int, head_offset: int,
                  heads_total: Optional[int], device) -> torch.Tensor:
    """[B * H] int64: (b + row_offset) * heads_total + h + head_offset, the
    mask stream of each local (b, h) (``csrc/common.cuh`` dropout_stream)."""
    row_offset, head_offset, heads_total = _offsets(H, row_offset, head_offset, heads_total)
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None] + row_offset
    h = torch.arange(H, dtype=torch.int64, device=device)[None, :] + head_offset
    return (b * heads_total + h).reshape(-1)


def dropout_bits(key, rows, cols):
    """``csrc/common.cuh`` dropout_bits in int64: the 32 hash bits of every
    (query row, key column) for each stream key, [len(key), len(rows),
    len(cols)]. The low 16 bits of row and column packed into one word, xor
    the key, xor a mix of their high 16 bits (0 below 65536, since
    mix32(0) = 0)."""
    rows, cols = rows[:, None], cols[None, :]
    low = ((rows & 0xFFFF) << 16) | (cols & 0xFFFF)
    high = _mix32(((rows >> 16) << 16) | (cols >> 16))
    return _mix32((low ^ high)[None] ^ key[:, None, None])


def dropout_keep_mask(seed: int, B: int, H: int, T: int, p: float, device=None,
                      row_offset: int = 0, head_offset: int = 0,
                      heads_total: Optional[int] = None, rows: Optional[tuple] = None,
                      cols: Optional[tuple] = None) -> torch.Tensor:
    """[B, H, T, T] bool keep mask of ``csrc/common.cuh`` (dropout_key,
    dropout_bits) for int32 `seed`: entry (b, h, i, j) depends on nothing
    but (seed, (b + row_offset) * heads_total + h + head_offset, i, j), so
    padding T leaves it unchanged, and a rank's block at its offsets is the
    block of the global mask. `rows` and `cols` ((start, stop) of query rows
    and key columns, each within [0, T]) draw that block of it alone."""
    thresh = dropout_threshold(p)
    bh = _stream_index(B, H, row_offset, head_offset, heads_total, device)
    key = _mix32((int(seed) & _M32) ^ _mix32((_mul32(bh, 0x9E3779B9) + 0x632BE5AB) & _M32))
    r0, r1 = rows if rows is not None else (0, T)
    c0, c1 = cols if cols is not None else (0, T)
    if not (0 <= r0 <= r1 <= T and 0 <= c0 <= c1 <= T):
        raise ValueError(f"dropout_keep_mask: rows {rows} and cols {cols} must lie in [0, {T}]")
    bits = dropout_bits(key, torch.arange(r0, r1, dtype=torch.int64, device=device),
                        torch.arange(c0, c1, dtype=torch.int64, device=device))
    return (bits >= thresh).view(B, H, r1 - r0, c1 - c0)


def attention_dropout_reference(q, k, v, key_bias, seed, p: float, sm_scale: float,
                                row_offset: int = 0, head_offset: int = 0,
                                heads_total: Optional[int] = None) -> torch.Tensor:
    """Plain version with dropout: f32 softmax, kept entries scaled by
    1/(1-p), cast to v's dtype, then P V. At p = 0 it is
    ``attention_reference``; the offsets place the mask
    (``dropout_keep_mask``)."""
    if p == 0.0:
        return attention_reference(q, k, v, key_bias, sm_scale)
    B, H, T, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + key_bias.float()[:, None, None, :]
    prob = torch.softmax(s, dim=-1)
    keep = dropout_keep_mask(int(seed.reshape(-1)[0]), B, H, T, p, device=q.device,
                             row_offset=row_offset, head_offset=head_offset,
                             heads_total=heads_total)
    keep_scale = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    prob = torch.where(keep, prob * keep_scale.to(prob.device), 0.0)
    return torch.matmul(prob.to(v.dtype), v)


def _check(name: str, q, k, v, key_bias) -> list:
    """Raise on what the kernels do not take; return the [B, H, T] strides
    of q, k and v, flat (the C entries' stride arguments)."""
    B, H, T, dh = q.shape
    if not _kernel_takes(dh):
        raise ValueError(f"{name}: head dim {dh} is not in {KERNEL_HEAD_DIMS} or a multiple "
                         f"of 128 above them")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    if (k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype
            or k.get_device() != q.get_device() or v.get_device() != q.get_device()):
        raise ValueError(f"{name}: k and v must match q in shape/dtype/device")
    (qb, qh, qt, qd), (kb, kh, kt, kd), (vb, vh, vt, vd) = q.stride(), k.stride(), v.stride()
    if qd != 1 or kd != 1 or vd != 1:
        raise ValueError(f"{name}: q, k and v need a contiguous head dim")
    if key_bias.shape != (B, T):
        raise ValueError(f"{name}: key_bias must be [B, T] = {(B, T)}")
    if q.dtype == torch.bfloat16 and not all(map(_rows_aligned, (q, k, v))):
        raise ValueError(f"{name}: bf16 q, k, v need 16-byte aligned rows "
                         f"(strides over B, H, T in multiples of 8)")
    return [qb, qh, qt, kb, kh, kt, vb, vh, vt]


def _same_shape(name: str, q, k, v) -> None:
    """Raise unless k and v have q's shape (checked before any padding)."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: k and v must match q in shape/dtype/device")


def _rows_aligned(t) -> bool:
    """Whether every [.., .., t, :] row of `t` starts on 16 bytes, as the
    bf16 kernels' 16-byte asynchronous copies need."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _f32_bias(key_bias, device):
    if key_bias.dtype == torch.float32 and key_bias.device == device and key_bias.is_contiguous():
        return key_bias
    return key_bias.to(device=device, dtype=torch.float32).contiguous()


def _stream(device) -> int:
    """The current CUDA stream of `device` as an integer handle: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without building
    a Stream object on every launch (the accessor Triton's and Inductor's
    launchers use)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def kv_end(key_bias) -> torch.Tensor:
    """[B] int32: one past the last key of each item whose bias is above
    NEG_INF / 2, and T for an item with no such key (it keeps every key: the
    uniform average). The plain version of the pre-pass kernel that each
    attention C entry launches before its kernel (``csrc/attention_common.cuh``),
    which skips key tiles at or past it; on the device, no host sync.
    ``chip_smoke.py`` counts the skipped tiles of the training buckets with
    it, and the card tests place keys that no kernel may read with it."""
    B, T = key_bias.shape
    pos = torch.arange(1, T + 1, dtype=torch.int32, device=key_bias.device)
    last = torch.where(key_bias > NEG_INF / 2, pos, 0).amax(dim=1)
    return torch.where(last > 0, last, T).to(torch.int32).contiguous()


def _seed_arg(seed, p: float, device):
    """(the seed as an int32 device tensor, its pointer) for the kernels,
    which read it on the device; (None, None) at p = 0. The caller holds the
    tensor until the launch is queued."""
    if p == 0.0:
        return None, None
    if seed.dtype != torch.int32 or seed.device != device:
        seed = seed.to(device=device, dtype=torch.int32)
    return seed, seed.data_ptr()


_FWD_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_float]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)
_FWD_ENTRIES = {"attention_fwd": _FWD_ARGTYPES,
                "attention_fwd_column_groups": [ctypes.c_int, ctypes.c_int]}


def fwd_column_groups(dh: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The column groups of O kernel A runs head dim `dh` in, as its C entry
    routes it (``csrc/attention_common.cuh`` group_width) at
    ``kernel_head_dim(dh)``: 1 up to 256 and, in bf16, up to 768 (one block
    computes each score once for all its columns); above, the padded head dim
    over the group width, each group recomputing S. Builds the kernel's
    source on first use, so it needs nvcc."""
    lib = build.load("attention_fwd", _FWD_ENTRIES)
    return lib.attention_fwd_column_groups(_DTYPE_CODES[dtype], kernel_head_dim(dh))


def _out_like(q) -> torch.Tensor:
    """The kernel's [B, H, T, dh] output, laid out [B, T, H, dh] so the
    caller's merge of heads is a view."""
    B, H, T, dh = q.shape
    return torch.empty_strided((B, H, T, dh), (T * H * dh, dh, H * dh, 1), dtype=q.dtype,
                               device=q.device)


def _lse_like(q, with_lse: bool) -> torch.Tensor:
    """[B, H, T] f32 log-sum-exp, or an empty tensor when it was not asked
    for (an op has one output structure)."""
    B, H, T, _ = q.shape
    return q.new_empty((B, H, T) if with_lse else (0,), dtype=torch.float32)


def _launch_fwd(q, k, v, key_bias, sm_scale: float, p: float, seed, with_lse: bool,
                row_offset: int = 0, head_offset: int = 0, heads_total: Optional[int] = None):
    """Kernel A: the ctypes launch of ``csrc/attention_fwd.cu`` at a built
    head dim; (o, lse)."""
    thresh = dropout_threshold(p)
    strides = _check("attention_fwd", q, k, v, key_bias)
    B, H, T, dh = q.shape
    offsets = _offsets(H, row_offset, head_offset, heads_total)
    device = q.device
    key_bias = _f32_bias(key_bias, device)
    ends = torch.empty(B, dtype=torch.int32, device=device)  # the kernel's kv_end pre-pass
    o = _out_like(q)
    lse = _lse_like(q, with_lse)
    seed_t, seed_ptr = _seed_arg(seed, p, device)

    lib = build.load("attention_fwd", _FWD_ENTRIES)
    err = build.launch(
        device, lib.attention_fwd, _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), ends.data_ptr(),
        o.data_ptr(), lse.data_ptr() if with_lse else None, seed_ptr,
        B, H, T, dh, *strides, *o.stride()[:3],
        sm_scale, thresh, 1.0 / (1.0 - p), *offsets, _stream(device),
    )
    build.check(lib, err, "attention_fwd")
    build.count(attention_fwd)
    return o, lse


@torch.library.custom_op("fs2t::attention_fwd", mutates_args=(), device_types="cuda")
def _attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_bias: torch.Tensor, sm_scale: float, p: float,
                      seed: Optional[torch.Tensor], with_lse: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: the ctypes launch of ``csrc/attention_fwd.cu`` at the
    default dropout offsets, through the padding step."""
    return padded_fwd(_launch_fwd, q, k, v, key_bias, sm_scale, p, seed, with_lse)


@_attention_fwd_op.register_kernel("cpu")
def _attention_fwd_cpu(q, k, v, key_bias, sm_scale, p, seed, with_lse):
    """The plain version, copied into the kernel's output layout."""
    o = _out_like(q)
    o.copy_(attention_dropout_reference(q, k, v, key_bias, seed, p, sm_scale))
    lse = _lse_like(q, with_lse)
    if with_lse:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
        lse.copy_(torch.logsumexp(s + key_bias.float()[:, None, None, :], dim=-1))
    return o, lse


@_attention_fwd_op.register_fake
def _attention_fwd_fake(q, k, v, key_bias, sm_scale, p, seed, with_lse):
    return _out_like(q), _lse_like(q, with_lse)


@register_flop_formula(torch.ops.fs2t.attention_fwd)
def _attention_fwd_op_flops(q_shape, *args, out_shape=None, **kwargs) -> int:
    return attention_fwd_flops(*q_shape)


def attention_fwd(q, k, v, key_bias, sm_scale: float, p: float = 0.0, seed=None,
                  with_lse: bool = False):
    """[B, H, T, dh] attention output in q's dtype (laid out [B, T, H, dh]
    so the caller's merge of heads is a view); with `with_lse` also the
    [B, H, T] f32 log-sum-exp of the scaled, biased scores. `seed` is an
    int32 tensor of one element, read only when p > 0. Runs the op
    ``fs2t::attention_fwd``: kernel A on the card, the plain version on the
    CPU, its fake under ``torch.export``."""
    dropout_threshold(p)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    o, lse = _attention_fwd_op(q, k, v, key_bias, float(sm_scale), float(p),
                               seed if p > 0.0 else None, with_lse)
    return (o, lse) if with_lse else o


attention_fwd.launches = 0


def attention_bwd_reference(q, k, v, key_bias, seed, p: float, sm_scale: float, do,
                            row_offset: int = 0, head_offset: int = 0,
                            heads_total: Optional[int] = None):
    """Plain version of the backward: autograd through the plain forward."""
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = attention_dropout_reference(qr, kr, vr, key_bias, seed, p, sm_scale,
                                        row_offset, head_offset, heads_total)
        return torch.autograd.grad(o, (qr, kr, vr), do)


_BWD_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 15 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_float]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)
_BWD_ENTRIES = {"attention_bwd": _BWD_ARGTYPES,
                "attention_bwd_column_groups": [ctypes.c_int, ctypes.c_int]}


def bwd_column_groups(dh: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The column groups of dK, dV and dQ kernel A′ runs head dim `dh` in,
    as its C entry routes it (``csrc/attention_common.cuh`` group_width) at
    ``kernel_head_dim(dh)``: 1 up to 256, and above it the padded head dim
    over the group width. Each group recomputes S^T and dP^T. Builds the
    kernel's source on first use, so it needs nvcc."""
    lib = build.load("attention_bwd", _BWD_ENTRIES)
    return lib.attention_bwd_column_groups(_DTYPE_CODES[dtype], kernel_head_dim(dh))


def attention_bwd(q, k, v, key_bias, seed, p: float, sm_scale: float, o, lse, do,
                  row_offset: int = 0, head_offset: int = 0,
                  heads_total: Optional[int] = None):
    """(dQ, dK, dV) in q's dtype for the forward's output `o` and
    log-sum-exp `lse` (``attention_fwd(..., with_lse=True)``) and the output
    gradient `do`; the key bias gets none. The offsets are the forward's."""
    thresh = dropout_threshold(p)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, key_bias, seed, p, sm_scale, do,
                                       row_offset, head_offset, heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    for name, t in (("do", do), ("o", o)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention_bwd: {name} must match q in shape/dtype/device")
    return padded_bwd(_launch_bwd, q, k, v, o, do, key_bias, seed, thresh, p, sm_scale, lse,
                      row_offset, head_offset, heads_total, attention_bwd_flops(*q.shape))


def _launch_bwd(q, k, v, o, do, key_bias, seed, thresh: int, p: float, sm_scale: float, lse,
                row_offset: int, head_offset: int, heads_total: Optional[int], flops: int):
    """Kernel A′: the ctypes launch of ``csrc/attention_bwd.cu`` at a built
    head dim; (dQ, dK, dV) in q's dtype. `flops` is the plain backward's
    count at the caller's true head dim, which the launch adds to
    ``attention_bwd.flops``."""
    strides = _check("attention_bwd", q, k, v, key_bias)
    B, H, T, dh = q.shape
    offsets = _offsets(H, row_offset, head_offset, heads_total)
    device = q.device
    if lse.shape != (B, H, T):
        raise ValueError("attention_bwd: lse must be [B, H, T]")
    if do.stride(3) != 1 or (do.dtype == torch.bfloat16 and not _rows_aligned(do)):
        do = do.contiguous()
    if o.stride(3) != 1:
        o = o.contiguous()
    key_bias = _f32_bias(key_bias, device)
    lse = lse.float().contiguous()
    # scratch the C entry's pre-pass kernels fill: kv_end, D = rowsum(dO * O),
    # and the f32 dQ buffer (zeroed) that the kernel sums into
    ends = torch.empty(B, dtype=torch.int32, device=device)
    dsum = torch.empty((B, H, T), dtype=torch.float32, device=device)
    dq_acc = torch.empty((B, H, T, dh), dtype=torch.float32, device=device)
    dk = torch.empty((B, H, T, dh), dtype=q.dtype, device=device)
    dv = torch.empty_like(dk)
    seed_t, seed_ptr = _seed_arg(seed, p, device)

    lib = build.load("attention_bwd", _BWD_ENTRIES)
    err = build.launch(
        device, lib.attention_bwd, _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
        key_bias.data_ptr(), ends.data_ptr(), lse.data_ptr(), dsum.data_ptr(), seed_ptr,
        dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, T, dh,
        *strides, *do.stride()[:3], *o.stride()[:3],
        sm_scale, thresh, 1.0 / (1.0 - p), *offsets, _stream(device),
    )
    build.check(lib, err, "attention_bwd")
    build.count(attention_bwd, flops=flops)
    return dq_acc.to(q.dtype), dk, dv


attention_bwd.launches = 0
attention_bwd.flops = 0


class _AttentionWithDropout(torch.autograd.Function):
    """Kernel A forward and A′ backward on CUDA tensors. At the default
    offsets A is reached through the op, as every other caller reaches it;
    a distributed rank's other offsets go to the ctypes launch directly,
    which the op's schema cannot carry, so ``FlopCounterMode`` does not
    count those launches (no path counts a distributed step's FLOPs; the
    op stays for the FLOP formula ``benchmark`` reads)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, p, sm_scale, row_offset=0, head_offset=0,
                heads_total=None):
        offsets = (row_offset, head_offset, heads_total)
        seed_p = seed if p > 0.0 else None
        if _offsets(q.shape[1], *offsets) == (0, 0, q.shape[1]):
            o, lse = attention_fwd(q, k, v, key_bias, sm_scale, p=p, seed=seed, with_lse=True)
        else:
            o, lse = padded_fwd(_launch_fwd, q, k, v, key_bias, sm_scale, p, seed_p, True,
                                *offsets)
        ctx.save_for_backward(q, k, v, key_bias, seed, o, lse)
        ctx.p, ctx.sm_scale, ctx.offsets = p, sm_scale, offsets
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, seed, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, key_bias, seed, ctx.p, ctx.sm_scale, o, lse, do,
                                   *ctx.offsets)
        return dq, dk, dv, None, None, None, None, None, None, None


def attention_with_dropout(q, k, v, key_bias, seed, p: float, sm_scale: float,
                           row_offset: int = 0, head_offset: int = 0,
                           heads_total: Optional[int] = None):
    """Training attention, differentiable in q, k and v (JAX
    ``ops/attention_dropout.py::attention_with_dropout``): the kernels on the
    card, autograd through the plain version on the CPU. `seed` is an int32
    tensor of one element (the JAX package's seed array). The offsets place
    a distributed rank's rows and heads; a launch of A at offsets other than
    the defaults bypasses the op, so ``FlopCounterMode`` does not count it
    (no path counts a distributed step's FLOPs)."""
    if q.device.type == "cpu":
        return attention_dropout_reference(q, k, v, key_bias, seed, p, sm_scale,
                                           row_offset, head_offset, heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"attention_with_dropout: unsupported device {q.device}")
    return _AttentionWithDropout.apply(q, k, v, key_bias, seed, p, sm_scale, row_offset,
                                       head_offset, heads_total)
