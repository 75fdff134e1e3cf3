"""Width-1 monotonic alignment search (counterpart of the JAX package's
``ops/mas.py::mas_width1_batched``).

``mas_width1(log_attn, in_lens, out_lens)`` returns the one-hot Viterbi path
[B, T, L] f32 (zero on frames >= out_len) and the durations [B, L] int32. A
CUDA tensor launches ``csrc/mas_width1.cu`` (which replaces
``ops/mas_pallas.py:94 mas_width1_pallas``) or raises; a CPU tensor runs
``mas_width1_reference``, its plain version. Past ``RING_L`` columns the
kernel spreads an item over a thread-block cluster: a block a slice of
``SLICE_L`` columns, each taking the ``EDGE_COLUMNS`` left of its slice from
its neighbour every ``MEET_ROWS`` rows; past ``PANEL_L`` columns the
clusters run in panels of at most ``PANEL_L`` columns launched in turn, the
halo across a panel boundary handed on through device memory
(``cluster_layout`` reads the layout a launch takes from the C entry). Every
text length runs, as the JAX package's scan does. The search takes no
gradient. The C entry zeroes both outputs on the stream before the kernel
writes its ones.

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
RING_L = 1024  # one block an item up to here
# The cluster layout past RING_L, passed to the C entry (which refuses any
# other): a block owns SLICE_L columns and carries the EDGE_COLUMNS left of
# them, recomputed every row and taken afresh from the block on its left
# every MEET_ROWS rows. A halo column stays right one row less for every
# column it lies further left, so MEET_ROWS <= EDGE_COLUMNS keeps every
# owned column the plain version's. A launch takes at most PANEL_L
# columns (a cluster of eight blocks); a longer text runs in panels, one
# launch after another, the last EDGE_COLUMNS of a panel at every meet row
# written to device memory for the next panel's first block.
SLICE_L = 1024
EDGE_COLUMNS = 32
MEET_ROWS = 16
PANEL_L = 8 * SLICE_L


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
    return mas_backtrack(moves, in_lens, out_lens)


@torch.no_grad()
def mas_backtrack(moves, in_lens, out_lens):
    """The plain version's backtrack over its move decisions [B, T, L] (row
    i, column j: the path into (i, j) came from (i - 1, j - 1)): the one-hot
    path and the durations."""
    B, T, L = moves.shape
    dev = moves.device
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


def backtrack_window(word_hi: int, word_lo: int, c: int) -> int:
    """The kernel's 32-bit window of one row's move decisions around column
    `c`: bit p is the decision at column c - 31 + p (0 for a column below 0).
    `word_hi` is the row's decision word c // 32 (bit q: column 32 * (c // 32)
    + q) and `word_lo` the word before it (0 when c < 32). From column c the
    path falls by at most one column a row, so these windows hold every
    decision the next 32 rows of the backtrack can need."""
    return (((word_hi << 32) | word_lo) >> ((c & 31) + 1)) & 0xFFFFFFFF


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ENTRIES = {"mas_width1": _ARGTYPES,
            "mas_width1_cluster_layout": [ctypes.c_int, ctypes.c_void_p]}


def cluster_layout(L: int) -> dict:
    """The layout the C entry launches text length `L` in: blocks an item's
    cluster (1: the ring kernel), columns a block owns, halo columns a block
    takes from its left neighbour, rows between two meets, the clusters of
    that many blocks the current card holds at once (0 for the ring
    kernel), and the panels launched in turn (1 up to ``PANEL_L``). Builds
    the kernel's source on first use, so it needs nvcc and a card."""
    from ..kernels import build

    lib = build.load("mas_width1", _ENTRIES)
    out = (ctypes.c_int * 6)()
    build.check(lib, lib.mas_width1_cluster_layout(L, out), "mas_width1_cluster_layout")
    return dict(zip(("blocks", "slice", "edge", "meet", "max_active_clusters", "panels"), out))


@torch.no_grad()
def mas_width1(log_attn, in_lens, out_lens):
    """(attn_hard [B, T, L] f32, durations [B, L] int32)."""
    if log_attn.device.type == "cpu":
        return mas_width1_reference(log_attn, in_lens, out_lens)
    if log_attn.device.type != "cuda":
        raise ValueError(f"mas_width1: unsupported device {log_attn.device}")
    B, T, L = log_attn.shape
    if in_lens.shape != (B,) or out_lens.shape != (B,):
        raise ValueError("mas_width1: in_lens and out_lens must be [B]")
    dev = log_attn.device
    la = log_attn.to(torch.float32).contiguous()
    in_lens = in_lens.to(device=dev, dtype=torch.int32).contiguous()
    out_lens = out_lens.to(device=dev, dtype=torch.int32).contiguous()
    hard = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    durations = torch.empty((B, L), dtype=torch.int32, device=dev)
    bits = torch.empty((B, (L + 31) // 32, T), dtype=torch.int32, device=dev)
    # past PANEL_L the panels hand their halos over in [2, B, meets, EDGE_COLUMNS]
    # (panel p reads half (p - 1) % 2 and writes half p % 2)
    edges = (torch.empty((2, B, -(-T // MEET_ROWS), EDGE_COLUMNS), dtype=torch.float32,
                         device=dev) if L > PANEL_L else None)

    from ..kernels import build

    lib = build.load("mas_width1", _ENTRIES)
    err = build.launch(
        dev, lib.mas_width1, la.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(),
        hard.data_ptr(), durations.data_ptr(), bits.data_ptr(),
        None if edges is None else edges.data_ptr(), B, T, L, SLICE_L, EDGE_COLUMNS, MEET_ROWS,
        PANEL_L, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "mas_width1")
    build.count(mas_width1)
    return hard, durations


mas_width1.launches = 0
