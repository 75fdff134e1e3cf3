"""The decomposition the cluster kernels run past the rings' reach, on the CPU.

Past ``RING_L`` columns (MAS, kernel B) and ``RING_S`` states (CTC, kernel C)
a chain is cut into slices, one block of a thread-block cluster each. A
block recomputes a halo left of its slice every row or frame with the plain
arithmetic and takes the halo afresh from the block on its left only every
``MEET_ROWS`` rows (``EDGE_COLUMNS`` columns) or ``MEET_FRAMES`` frames
(``HALO_STATES`` states). This file runs the plain recurrences the same way,
slice by slice with the halo refreshed only at the meets, on the layout the
kernels take (the constants of ``ops/mas.py`` and ``ops/ctc.py`` that the C
entries are given) scaled down to small shapes, and asserts:

- MAS: the path and durations from the sliced forward equal
  ``mas_width1_reference``'s and JAX's ``mas_width1_batched``'s bit for bit
  (adds and maxes are exact), with ``in_len`` inside the first slice only,
  ending on a slice boundary and one past it, ``out_len`` 1 and
  ``out_len`` < T;
- CTC: the sliced alpha and beta rows equal ``ctc_alpha_reference``'s and
  ``ctc_beta_reference``'s bit for bit (each slice runs the plain version's
  operations on tensors of the plain version's shape, so every element takes
  the same arithmetic), and the loss and gradient from them match JAX's
  ``ctc_forward_sum`` as ``test_torch_long_shapes.py`` holds them (loss
  within relative 1e-5, gradient within max-abs 1e-5, on alignment-shaped
  scores: the two frameworks' exp and log differ by an ulp at rare entries);
- a meet period one row (MAS) or frame (CTC) longer than the halo allows
  makes the sliced rows differ from the plain ones, so these tests can fail.

Past ``PANEL_L`` columns (MAS) and ``PANEL_S`` states (CTC) the clusters run
in panels launched in turn; a panel's first block takes its halo at each
meet from device memory: for MAS the last ``EDGE_COLUMNS`` columns of the
panel before it at the meet's row, for CTC that panel's stored rows of the
frame before the meet. ``mas_by_panels`` and ``ctc_by_panels`` run the
same on panels of two scaled slices, and the tests hold them bit for bit to
the plain versions and to JAX (MAS; CTC's loss and gradient as above) with
``in_len`` inside the first panel only, on a panel boundary and one past
it; a boundary handed one row (frame) late makes the rows differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu.ops import ctc as jctc
from fastspeech2_lightning_tpu.ops import mas as jmas
from fastspeech2_lightning_tpu_torch.ops import ctc, mas

torch.set_num_threads(2)

# the kernels' layout, scaled down: MAS slices of SLICE_L / 32 columns with
# a quarter of the halo and of the meet period; CTC slices of two warps of a
# quarter of WARP_STATES, a quarter of the halo and of the meet period
SCALE = 4
MAS_SLICE = mas.SLICE_L // 32
MAS_EDGE = mas.EDGE_COLUMNS // SCALE
MAS_MEET = mas.MEET_ROWS // SCALE
CTC_SLICE = 2 * ctc.WARP_STATES // SCALE
CTC_HALO = ctc.HALO_STATES // SCALE
CTC_MEET = ctc.MEET_FRAMES // SCALE
# panels of eight slices (MAS) and of up to eight blocks (CTC), scaled: two
PANEL_SLICES = 8 // SCALE


def test_layout_constants_keep_the_halo_valid_and_cover_every_shape():
    """The period a halo serves (a column a row for MAS, two states a frame
    for CTC), a panel's reach (one cluster of at most eight blocks), and
    the scaled layout keeps the ratios."""
    assert mas.MEET_ROWS <= mas.EDGE_COLUMNS and MAS_MEET <= MAS_EDGE
    assert 2 * ctc.MEET_FRAMES <= ctc.HALO_STATES and 2 * CTC_MEET <= CTC_HALO
    assert mas.SLICE_L * 8 == mas.PANEL_L and mas.RING_L == mas.SLICE_L
    assert mas.EDGE_COLUMNS <= mas.SLICE_L  # a panel's last slice holds the next one's halo
    assert ctc.SLICE_WARPS * ctc.WARP_STATES * ctc.MAX_CLUSTER >= ctc.PANEL_S
    assert ctc.HALO_STATES <= ctc.WARP_STATES
    assert ctc.WARP_STATES == 28 * ctc.HALO_STATES // 4  # 28 lanes own, 4 carry the halo
    assert CTC_SLICE % 2 == 0 and CTC_HALO % 2 == 0  # slices start on even (blank) states


# -- MAS (kernel B) ----------------------------------------------------------------


def mas_by_slices(log_attn, in_lens, out_lens, width, edge, meet):
    """The MAS forward as the cluster kernel runs it: slice r owns columns
    [r width, (r + 1) width) and carries the `edge` columns left of them
    (whose leftmost has no left neighbour: -inf), each row the plain
    version's adds and maxes; every `meet` rows, before row i0, a slice's
    halo takes slice r - 1's values of row i0 - 1 (``mas_by_panels`` with
    every slice in one panel). Returns the move decisions [B, T, L] and P's
    rows [B, T, L]."""
    L = log_attn.shape[2]
    return mas_by_panels(log_attn, in_lens, out_lens, width, edge, meet, -(-L // width))


MAS_B, MAS_T, MAS_L = 4, 120, 100  # four slices of 32 columns, the last of 4
MAS_CASES = {
    "full": ([MAS_L, 77, 40, 3], [MAS_T, 101, 60, 9]),
    "in_len_inside_the_first_slice": ([20, 9, 31, 32], [MAS_T, 50, 40, 32]),
    "in_len_on_a_slice_boundary": ([64, 96, 32, 64], [MAS_T, 110, 90, 64]),
    "in_len_one_past_a_slice_boundary": ([65, 97, 33, 65], [MAS_T, 110, 90, 65]),
    "out_len_1": ([MAS_L, 1, 40, 65], [1, 1, 1, 1]),
    "out_len_below_T": ([MAS_L, 64, 65, 33], [MAS_T - 1, 70, 66, 33]),
}


def _mas_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((MAS_B, MAS_T, MAS_L)).astype(np.float32)
    x[0, :, 1::3] = x[0, :, :1]  # exact ties between neighbours
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("case", list(MAS_CASES))
def test_mas_by_slices_equals_plain_version_and_jax(case):
    in_lens, out_lens = (np.array(v, np.int32) for v in MAS_CASES[case])
    la = _mas_inputs(len(case))
    t_la, t_in, t_out = torch.from_numpy(la), torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    moves, _ = mas_by_slices(t_la, t_in, t_out, MAS_SLICE, MAS_EDGE, MAS_MEET)
    hard, dur = mas.mas_backtrack(moves, t_in, t_out)
    want_hard, want_dur = mas.mas_width1_reference(t_la, t_in, t_out)
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)
    j_hard, j_dur = jmas.mas_width1_batched(jnp.asarray(la), jnp.asarray(in_lens),
                                            jnp.asarray(out_lens))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(j_hard))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(j_dur))
    assert dur.sum(1).tolist() == out_lens.tolist()


@pytest.mark.parametrize("meet", [MAS_MEET, MAS_EDGE])
def test_mas_by_slices_holds_every_row_up_to_the_halo(meet):
    """Every P row of every owned column equals the single-slice run's, at the
    kernel's period and at the longest the halo allows."""
    la = torch.from_numpy(_mas_inputs(7))
    in_lens, out_lens = torch.full((MAS_B,), MAS_L), torch.full((MAS_B,), MAS_T)
    moves, rows = mas_by_slices(la, in_lens, out_lens, MAS_SLICE, MAS_EDGE, meet)
    want_moves, want_rows = mas_by_slices(la, in_lens, out_lens, MAS_L, 0, MAS_T)
    assert torch.equal(rows, want_rows) and torch.equal(moves, want_moves)


def test_mas_by_slices_differs_one_row_past_the_halo():
    """A meet every EDGE + 1 rows: the halo's leftmost column, with no left
    neighbour, reaches the first owned column on the last row of a period.
    On scores falling to the right the left neighbour is every column's max,
    so the slices' rows differ from the plain ones."""
    j = np.arange(MAS_L, dtype=np.float32)
    la = torch.from_numpy(np.broadcast_to(-0.5 * j, (MAS_B, MAS_T, MAS_L)).copy())
    in_lens, out_lens = torch.full((MAS_B,), MAS_L), torch.full((MAS_B,), MAS_T)
    _, rows = mas_by_slices(la, in_lens, out_lens, MAS_SLICE, MAS_EDGE, MAS_EDGE + 1)
    _, want = mas_by_slices(la, in_lens, out_lens, MAS_L, 0, MAS_T)
    assert not torch.equal(rows, want)
    _, rows = mas_by_slices(la, in_lens, out_lens, MAS_SLICE, MAS_EDGE, MAS_EDGE)
    assert torch.equal(rows, want)


# -- CTC (kernel C) ----------------------------------------------------------------


def ctc_by_slices(logprobs, in_lens, out_lens, width, halo, meet, beta=False):
    """The alpha (or beta) scan as the cluster kernel runs it. In the
    chain's order (s for alpha, s' = S - 1 - s for beta) slice r owns
    states [r width, (r + 1) width) and carries the `halo` states before
    them. Each slice keeps a whole row and runs the plain version's
    operations on it; after every frame the states before its halo are set
    to NEG_INF (it does not know them), and before every `meet`-th step a
    slice's halo takes slice r - 1's states (``ctc_by_panels`` with every
    slice in one panel). Returns the rows [B, T, S] assembled from the
    owned states."""
    S = 2 * logprobs.shape[2] - 1
    return ctc_by_panels(logprobs, in_lens, out_lens, width, halo, meet, -(-S // width), beta)


CTC_B, CTC_T, CTC_L = 4, 70, 60  # S 121: three slices of 56 states, the last of 9


def _alignment_logprobs(B, T, L, in_lens, out_lens, seed):
    """log-softmax over a blank column and scores shaped like a learned
    alignment (``test_torch_long_shapes.py``'s), keys past in_len at
    NEG_INF."""
    rng = np.random.default_rng(seed)
    attn = 0.5 * rng.standard_normal((B, T, L))
    for b in range(B):
        centers = np.arange(T) / max(out_lens[b] - 1, 1) * (in_lens[b] - 1)
        attn[b] -= (np.arange(L)[None] - centers[:, None]) ** 2 / (2 * 2.0 ** 2)
    logits = np.concatenate([np.full((B, T, 1), -1.0), attn], -1)
    logits = np.where(np.arange(L + 1)[None, None] > in_lens[:, None, None], jctc.NEG_INF,
                      logits).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


CTC_CASES = {
    "full": ([CTC_L, 45, 28, 1], [CTC_T, 66, 40, CTC_T]),
    "out_len_1_and_short": ([1, 20, CTC_L, 27], [1, 21, 64, 30]),
}


@pytest.mark.parametrize("case", list(CTC_CASES))
@pytest.mark.parametrize("beta", [False, True])
def test_ctc_by_slices_equals_plain_version(case, beta):
    in_lens, out_lens = (np.array(v, np.int32) for v in CTC_CASES[case])
    lp = torch.from_numpy(_alignment_logprobs(CTC_B, CTC_T, CTC_L, in_lens, out_lens, 3))
    t_in, t_out = torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    rows = ctc_by_slices(lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_MEET, beta=beta)
    want = (ctc.ctc_beta_reference(lp, t_in, t_out) if beta
            else ctc.ctc_alpha_reference(lp, t_out))
    assert torch.equal(rows, want)


def test_ctc_by_slices_loss_and_gradient_match_jax():
    """The loss from the sliced alpha rows and the gradient from the sliced
    alpha and beta rows against JAX's ctc_forward_sum and its gradient."""
    in_lens, out_lens = (np.array(v, np.int32) for v in CTC_CASES["full"])
    lp = _alignment_logprobs(CTC_B, CTC_T, CTC_L, in_lens, out_lens, 5)
    t_lp, t_in, t_out = torch.from_numpy(lp), torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    alphas = ctc_by_slices(t_lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_MEET)
    betas = ctc_by_slices(t_lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_MEET, beta=True)
    ll = ctc._final_ll(alphas[:, -1], t_in)
    w = np.array([0.3, 1.0, 0.7, 0.5], np.float32)
    grad = ctc.ctc_grad_reference(alphas, betas, t_out, ll, torch.from_numpy(w))
    j_loss = jctc.ctc_forward_sum(jnp.asarray(lp), jnp.asarray(in_lens), jnp.asarray(out_lens))
    j_grad = jax.grad(lambda x: jnp.sum(jctc.ctc_forward_sum(
        x, jnp.asarray(in_lens), jnp.asarray(out_lens)) * w))(jnp.asarray(lp))
    assert bool(torch.isfinite(ll).all())
    np.testing.assert_allclose((-ll).numpy(), np.asarray(j_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=0, atol=1e-5)


@pytest.mark.parametrize("beta", [False, True])
def test_ctc_by_slices_differs_one_frame_past_the_halo(beta):
    """A meet every HALO / 2 + 1 frames: the states the halo's first ones
    could not know reach the first owned state on the period's last frame,
    and the sliced rows differ from the plain ones."""
    in_lens, out_lens = (np.array(v, np.int32) for v in CTC_CASES["full"])
    lp = torch.from_numpy(_alignment_logprobs(CTC_B, CTC_T, CTC_L, in_lens, out_lens, 3))
    t_in, t_out = torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    want = (ctc.ctc_beta_reference(lp, t_in, t_out) if beta
            else ctc.ctc_alpha_reference(lp, t_out))
    rows = ctc_by_slices(lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_HALO // 2 + 1, beta=beta)
    assert not torch.equal(rows, want)


# -- panels (texts past one cluster's reach) -----------------------------------------


def mas_by_panels(log_attn, in_lens, out_lens, width, edge, meet, panel, lag=0):
    """The MAS forward as the kernel runs it past PANEL_L: panels of `panel`
    slices one after the other, each as ``mas_by_slices`` runs a cluster,
    except that a panel's first slice takes its halo at each meet (before
    row i0) from what the panel before it wrote to device memory: its last
    `edge` columns of row i0 - 1 (of row i0 - 1 - `lag` for a boundary
    handed late). Returns the move decisions and P's rows [B, T, L]."""
    la = mas._masked(log_attn, in_lens, out_lens)
    B, T, L = la.shape
    cols = torch.arange(L)
    moves = torch.zeros((B, T, L), dtype=torch.bool)
    rows = torch.full((B, T, L), float("nan"))
    for p0 in range(0, L, panel * width):
        starts = list(range(p0, min(p0 + panel * width, L), width))
        los = [max(c0 - edge, 0) for c0 in starts]
        his = [min(c0 + width, L) for c0 in starts]
        state = [la[:, 0, lo:hi] + torch.where(cols[lo:hi] == 0, 0.0, mas.NEG_INF)
                 for lo, hi in zip(los, his)]

        def owned(r, x, i):
            rows[:, i, starts[r]:his[r]] = x[:, starts[r] - los[r]:]

        for r, x in enumerate(state):
            owned(r, x, 0)
        for i in range(1, T):
            if i % meet == 0:
                for r in range(len(starts) - 1, 0, -1):
                    n = starts[r] - los[r]
                    state[r] = torch.cat([state[r - 1][:, -n:], state[r][:, n:]], 1)
                if p0 > 0:  # across the panel boundary, from device memory
                    state[0] = torch.cat([rows[:, i - 1 - lag, p0 - edge:p0],
                                          state[0][:, edge:]], 1)
            for r, (lo, hi) in enumerate(zip(los, his)):
                x = state[r]
                left = torch.cat([torch.full((B, 1), -float("inf")), x[:, :-1]], 1)
                mv = (left >= x) & (cols[lo:hi] != 0)
                moves[:, i, starts[r]:hi] = mv[:, starts[r] - lo:]
                state[r] = torch.clamp(la[:, i, lo:hi] + torch.maximum(x, left),
                                       min=mas.NEG_INF)
                owned(r, state[r], i)
    return moves, rows


MAS_PANEL_L, MAS_PANEL_T = 150, 90  # panels of 64, 64 and 22 columns
MAS_PANEL_CASES = {
    "in_len_inside_the_first_panel": ([40, 63, 17, 64], [MAS_PANEL_T, 80, 30, 64]),
    "in_len_on_a_panel_boundary": ([64, 128, 64, 128], [MAS_PANEL_T, 85, 70, 128 - 40]),
    "in_len_one_past_a_panel_boundary": ([65, 129, 65, MAS_PANEL_L],
                                         [MAS_PANEL_T, 89, 66, MAS_PANEL_T]),
}


@pytest.mark.parametrize("case", list(MAS_PANEL_CASES))
def test_mas_by_panels_equals_plain_version_and_jax(case):
    in_lens, out_lens = (np.array(v, np.int32) for v in MAS_PANEL_CASES[case])
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((4, MAS_PANEL_T, MAS_PANEL_L)).astype(np.float32)
    x[0, :, 1::3] = x[0, :, :1]  # exact ties between neighbours
    la = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    t_la, t_in, t_out = torch.from_numpy(la), torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    moves, _ = mas_by_panels(t_la, t_in, t_out, MAS_SLICE, MAS_EDGE, MAS_MEET, PANEL_SLICES)
    hard, dur = mas.mas_backtrack(moves, t_in, t_out)
    want_hard, want_dur = mas.mas_width1_reference(t_la, t_in, t_out)
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)
    j_hard, j_dur = jmas.mas_width1_batched(jnp.asarray(la), jnp.asarray(in_lens),
                                            jnp.asarray(out_lens))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(j_hard))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(j_dur))


@pytest.mark.parametrize("lag", [0, 1])
def test_mas_by_panels_rows_and_a_boundary_handed_late(lag):
    """Every P row of every column equals the single-slice run's when the
    boundary is handed at its row, and differs when it is handed one row
    late, on scores falling to the right (the left neighbour is every
    column's max, so the boundary's column reaches the next panel's)."""
    j = np.arange(MAS_PANEL_L, dtype=np.float32)
    rng = np.random.default_rng(11)
    x = -0.5 * j + 0.1 * rng.standard_normal((2, MAS_PANEL_T, MAS_PANEL_L)).astype(np.float32)
    la = torch.from_numpy(x.astype(np.float32))
    in_lens, out_lens = torch.full((2,), MAS_PANEL_L), torch.full((2,), MAS_PANEL_T)
    moves, rows = mas_by_panels(la, in_lens, out_lens, MAS_SLICE, MAS_EDGE, MAS_MEET,
                                PANEL_SLICES, lag=lag)
    want_moves, want_rows = mas_by_slices(la, in_lens, out_lens, MAS_PANEL_L, 0, MAS_PANEL_T)
    assert (torch.equal(rows, want_rows) and torch.equal(moves, want_moves)) == (lag == 0)


def ctc_by_panels(logprobs, in_lens, out_lens, width, halo, meet, panel, beta=False, lag=0):
    """The alpha (or beta) scan as the kernel runs it past PANEL_S: panels
    of `panel` slices in the chain's order, one after the other, each as
    ``ctc_by_slices`` runs a cluster, except that a panel's first slice
    takes its halo at each meet from the rows the panels before it stored:
    the frame before the meet (alpha: row t - 1; beta: row t + 1), or the
    one `lag` frames before that for a boundary handed late. Returns the
    rows [B, T, S]."""
    emis = ctc._emissions(logprobs, out_lens)
    B, T, S = emis.shape
    order = torch.arange(S)
    if beta:
        order = S - 1 - order
    odd = (torch.arange(S) % 2 == 1)[None, :]
    rows = torch.full((B, T, S), float("nan"))
    s_blank, s_label = ctc._final_states(in_lens, S)
    s_ids = torch.arange(S)
    for p0 in range(0, S, panel * width):
        starts = list(range(p0, min(p0 + panel * width, S), width))
        known = [order >= c0 - halo for c0 in starts]
        own = [(order >= c0) & (order < c0 + width) for c0 in starts]
        halos = [(order >= c0 - halo) & (order < c0) for c0 in starts]

        def forget(x, r):
            return torch.where(known[r][None], x, ctc.NEG_INF)

        def meet_halos(state, stored):
            for r in range(len(starts) - 1, 0, -1):
                state[r] = torch.where(halos[r][None], state[r - 1], state[r])
            if p0 > 0:  # across the panel boundary, from the stored rows
                state[0] = torch.where(halos[0][None], rows[:, stored], state[0])

        def assemble(state, t):
            for r, x in enumerate(state):
                rows[:, t] = torch.where(own[r][None], x, rows[:, t])

        if not beta:
            init = torch.full((B, S), ctc.NEG_INF)
            init[:, 0] = 0.0
            state = [forget(init, r) for r in range(len(starts))]
            for t in range(T):
                if t > 0 and t % meet == 0:
                    meet_halos(state, t - 1 - lag)
                for r, prev in enumerate(state):
                    skip = torch.where(odd, ctc._shift(prev, 2), ctc.NEG_INF)
                    nxt = torch.clamp(ctc._lse3(prev, ctc._shift(prev, 1), skip) + emis[:, t],
                                      min=ctc.NEG_INF)
                    state[r] = forget(nxt, r)
                assemble(state, t)
            continue
        init = torch.where((s_ids[None] == s_blank[:, None]) | (s_ids[None] == s_label[:, None]),
                           0.0, ctc.NEG_INF)
        state = [forget(init, r) for r in range(len(starts))]
        assemble(state, T - 1)
        for j in range(1, T):
            t = T - 1 - j
            if j % meet == 0:
                meet_halos(state, t + 1 + lag)
            for r, bt in enumerate(state):
                w = bt + emis[:, t + 1]
                nxt = torch.clamp(ctc._lse3(w, ctc._shift(w, -1),
                                            torch.where(odd, ctc._shift(w, -2), ctc.NEG_INF)),
                                  min=ctc.NEG_INF)
                state[r] = forget(nxt, r)
            assemble(state, t)
    return rows


# S 121 over CTC_T frames, as the slice tests: panels of 112 and 9 states
CTC_PANEL_L, CTC_PANEL_T = CTC_L, CTC_T
CTC_PANEL_CASES = {  # final states 2 in_len - 1 and 2 in_len against the boundary 112
    "in_len_inside_the_first_panel": ([40, 55, 1, 30], [CTC_PANEL_T, 66, 9, 31]),
    "in_len_on_a_panel_boundary": ([56, 56, 56, 56], [CTC_PANEL_T, 60, 56, 69]),
    "in_len_one_past_a_panel_boundary": ([57, CTC_PANEL_L, 58, 57],
                                         [CTC_PANEL_T, CTC_PANEL_T, 64, 57]),
}


@pytest.mark.parametrize("case", list(CTC_PANEL_CASES))
def test_ctc_by_panels_equals_plain_version_and_jax(case):
    """Both chains' rows from the panels equal the plain version's bit for
    bit; the loss and gradient from them match JAX's ``ctc_forward_sum`` as
    ``test_ctc_by_slices_loss_and_gradient_match_jax`` holds them (the two
    frameworks' exp and log differ by an ulp at rare entries)."""
    in_lens, out_lens = (np.array(v, np.int32) for v in CTC_PANEL_CASES[case])
    lp = _alignment_logprobs(4, CTC_PANEL_T, CTC_PANEL_L, in_lens, out_lens, 13)
    t_lp, t_in, t_out = torch.from_numpy(lp), torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    alphas = ctc_by_panels(t_lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_MEET, PANEL_SLICES)
    betas = ctc_by_panels(t_lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_MEET, PANEL_SLICES,
                          beta=True)
    assert torch.equal(alphas, ctc.ctc_alpha_reference(t_lp, t_out))
    assert torch.equal(betas, ctc.ctc_beta_reference(t_lp, t_in, t_out))
    ll = ctc._final_ll(alphas[:, -1], t_in)
    w = np.array([0.3, 1.0, 0.7, 0.5], np.float32)
    grad = ctc.ctc_grad_reference(alphas, betas, t_out, ll, torch.from_numpy(w))
    j_loss = jctc.ctc_forward_sum(jnp.asarray(lp), jnp.asarray(in_lens), jnp.asarray(out_lens))
    j_grad = jax.grad(lambda x: jnp.sum(jctc.ctc_forward_sum(
        x, jnp.asarray(in_lens), jnp.asarray(out_lens)) * w))(jnp.asarray(lp))
    assert bool(torch.isfinite(ll).all())
    np.testing.assert_allclose((-ll).numpy(), np.asarray(j_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=0, atol=1e-5)


@pytest.mark.parametrize("beta", [False, True])
def test_ctc_by_panels_differs_with_a_boundary_handed_late(beta):
    """The stored rows one frame before the ones due: the next panel's rows
    differ from the plain ones."""
    in_lens, out_lens = (np.array(v, np.int32)
                         for v in CTC_PANEL_CASES["in_len_one_past_a_panel_boundary"])
    lp = torch.from_numpy(_alignment_logprobs(4, CTC_PANEL_T, CTC_PANEL_L, in_lens, out_lens, 13))
    t_in, t_out = torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    want = (ctc.ctc_beta_reference(lp, t_in, t_out) if beta
            else ctc.ctc_alpha_reference(lp, t_out))
    rows = ctc_by_panels(lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_MEET, PANEL_SLICES,
                         beta=beta, lag=1)
    assert not torch.equal(rows, want)


@pytest.mark.parametrize("beta", [False, True])
def test_ctc_by_panels_three_panels_equal_plain_version(beta):
    """S 261 over 150 frames: panels of 112, 112 and 37 states, the middle
    one taking its halo from the first's rows and handing its own to the
    last; the rows equal the plain version's bit for bit, with texts ending
    in each panel."""
    L, T = 130, 150
    in_lens, out_lens = np.array([40, 100, L, 113], np.int32), np.array([T, 140, T, 120], np.int32)
    lp = torch.from_numpy(_alignment_logprobs(4, T, L, in_lens, out_lens, 17))
    t_in, t_out = torch.from_numpy(in_lens), torch.from_numpy(out_lens)
    rows = ctc_by_panels(lp, t_in, t_out, CTC_SLICE, CTC_HALO, CTC_MEET, PANEL_SLICES, beta=beta)
    want = (ctc.ctc_beta_reference(lp, t_in, t_out) if beta
            else ctc.ctc_alpha_reference(lp, t_out))
    assert torch.equal(rows, want)
