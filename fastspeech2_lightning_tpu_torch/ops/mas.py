"""Width-1 monotonic alignment search (counterpart of the JAX package's
``ops/mas.py::mas_width1_batched``).

``mas_width1(log_attn, in_lens, out_lens)`` returns the one-hot Viterbi path
[B, T, L] f32 (zero on frames >= out_len) and the durations [B, L] int32. A
CUDA tensor launches ``csrc/mas_width1.cu`` (which replaces
``ops/mas_pallas.py:94 mas_width1_pallas``) or raises; a CPU tensor runs
``mas_width1_reference``, its plain version. There is no scan fallback: a
shape the kernel does not take raises. The search takes no gradient.

Recurrence (``ops/mas.py:30-51``; adds and maxes in one order, exact in f32):
    la     = valid ? max(log_attn, -1e9) : -1e9
    P[0,j] = la[0,j] + (j == 0 ? 0 : -1e9)
    P[i,j] = max(la[i,j] + max(P[i-1,j], P[i-1,j-1]), -1e9)
Backtrack from (out_len-1, in_len-1): step left iff j > 0 and
P[i-1,j-1] >= P[i-1,j]."""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e9
MAX_L = 1024  # one thread per text position


def _masked(log_attn, in_lens, out_lens):
    B, T, L = log_attn.shape
    j = torch.arange(L, device=log_attn.device)
    i = torch.arange(T, device=log_attn.device)
    valid = (j[None, None, :] < in_lens[:, None, None]) & (i[None, :, None] < out_lens[:, None, None])
    return torch.where(valid, torch.clamp(log_attn.float(), min=NEG_INF), NEG_INF)


@torch.no_grad()
def mas_width1_reference(log_attn, in_lens, out_lens):
    """Plain version: the DP row by row, then the backtrack, batched over B."""
    B, T, L = log_attn.shape
    dev = log_attn.device
    la = _masked(log_attn, in_lens, out_lens)
    first_col = torch.arange(L, device=dev) == 0
    neg = torch.full((B, 1), NEG_INF, device=dev)
    prev = la[:, 0] + torch.where(first_col, 0.0, NEG_INF)
    moves = torch.zeros((B, T, L), dtype=torch.bool, device=dev)
    for i in range(1, T):
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        moves[:, i] = (shifted >= prev) & ~first_col
        prev = torch.clamp(la[:, i] + torch.maximum(prev, shifted), min=NEG_INF)

    in_lens = in_lens.long()
    out_lens = out_lens.long()
    ok = (out_lens > 0) & (in_lens > 0) & (in_lens <= L)
    c = torch.where(ok, in_lens - 1, 0)[:, None]
    hard = torch.zeros((B, T, L), device=dev)
    rows = torch.arange(B, device=dev)
    for i in range(T - 1, 0, -1):
        active = ok & (i < out_lens)
        hard[:, i].scatter_(1, c, active.float()[:, None])
        step = active & moves[rows, i, c[:, 0]]
        c = c - step.long()[:, None]
    hard[:, 0].scatter_(1, c, ok.float()[:, None])
    return hard, hard.sum(1).to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@torch.no_grad()
def mas_width1(log_attn, in_lens, out_lens):
    """(attn_hard [B, T, L] f32, durations [B, L] int32)."""
    if log_attn.device.type == "cpu":
        return mas_width1_reference(log_attn, in_lens, out_lens)
    if log_attn.device.type != "cuda":
        raise ValueError(f"mas_width1: unsupported device {log_attn.device}")
    B, T, L = log_attn.shape
    if L > MAX_L:
        raise ValueError(f"mas_width1: text length {L} > {MAX_L}")
    if in_lens.shape != (B,) or out_lens.shape != (B,):
        raise ValueError("mas_width1: in_lens and out_lens must be [B]")
    dev = log_attn.device
    la = log_attn.to(torch.float32).contiguous()
    in_lens = in_lens.to(device=dev, dtype=torch.int32).contiguous()
    out_lens = out_lens.to(device=dev, dtype=torch.int32).contiguous()
    hard = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    durations = torch.empty((B, L), dtype=torch.int32, device=dev)
    bits = torch.empty((B, T, (L + 31) // 32), dtype=torch.int32, device=dev)

    from ..kernels import build

    lib = build.load("mas_width1", {"mas_width1": _ARGTYPES})
    err = lib.mas_width1(
        la.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(), hard.data_ptr(),
        durations.data_ptr(), bits.data_ptr(), B, T, L,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "mas_width1")
    mas_width1.launches += 1
    return hard, durations


mas_width1.launches = 0
