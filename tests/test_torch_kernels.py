"""The PyTorch port's CUDA kernels and their ctypes bindings.

On any host: every C entry in ``csrc/`` takes exactly the argument types its
Python wrapper declares (a mismatch would cut pointers or shift arguments,
and no compiler checks a ctypes call), and a wrapper given a tensor on a
device it has no kernel for raises instead of falling back.

On any host also: the MRF kernel's prepared weights (the bf16 pair of an f32
weight rebuilds it to 2^-16, and the plain version fed them equals the stage
reference), its routing gate, its refusal to run under autograd (it has no backward),
and the window arithmetic of the MAS kernel's
backtrack against a row-by-row walk; ``kv_end`` (the last unmasked key the attention kernels
stop at) on CPU tensors, the row alignment the bf16 attention kernels need,
and that the NaN keys the card tests place past ``kv_end`` would show a
kernel that read them.

On a CUDA card (marked ``gpu``; they skip elsewhere): each kernel agrees with
its plain version, in f32 within relative-L2 1e-5 and in bf16 within 2e-2 of
the plain version run in f32 on the same bf16-rounded inputs (attention
forward and backward, dropout included: the same seed gives the same mask,
read back bit for bit, at the default offsets and at a rank's (row, head)
offsets, where it is that block of the global mask;
masks with no valid key, with holes and at tile edges, T off the tiles,
dh 64, 128, 192 and 256 as built and every other dh to 256 through the
wrappers' zero padding, the wide head dims 384 to 768 (A in one block
computing each score once, A′ a block a group of output columns), dh
257 and 320 padded to 384 and dh 769 and 1000 padded to 896 and 1024 (A
a block a group of output columns), q, k, v as views of the fused
projection; A's bf16 kernels above dh 128 on full and ragged masks and an
item with no valid key, at T 1 to 1000 across the 64- and 128-row tiles
and at a rank's offsets, with its log-sum-exp and A′ fed it, and at p 0
bit for bit the launch without a seed; A and A′ at T 65600 at p 0 (with
every key of one item valid; held on slices of rows and keys) and at p 0.2
(held on slices of rows and keys across 65536, the mask of those rows
alone); the masks A and A′ draw read back bit for bit: at T 65536 equal to
the old 32-bit (row, col) packing's next to 65535, at T 65600 across 65536
equal to ``dropout_keep_mask``'s; A′'s dK and dV bit for bit the same over two bf16
launches at dh 160 to 512, and dQ element by element at most one bf16
rounding step and what reordering its f32 sum can move it apart;
NaN keys and values in the tiles past kv_end, which the kernels must not
read, and dK and dV exactly 0 there; at T = 1 (one key: dQ and dK are 0
in exact arithmetic) dQ and dK within the limit of the rounding of their
terms; the wide kernels' mask read back bit for bit across their column
groups);
the MRF conv in f32 within 5e-5, since it multiplies f32 inputs as split
bf16 pairs on the tensor cores, at T off its 128-row tile and under its halo,
with each epilogue mode, and on the edge rows alone, at C 16 to 128 and at
C 8 padded to 16, at spans past 50 and with even kernel sizes, and its stage
(18 launches) at C 32 to 128 and at the three B = 1 shapes of a low-latency
window of the V1 vocoder, and raising under autograd before it launches;
the whole-stage MRF kernel (one launch) at C 4 to 16 within the same
limits, on other stage shapes (k 1 to 65, even k, unequal dilation counts),
an even-k narrow stage past its halo on the per-conv route instead, and
raising under autograd before it launches;
MAS exactly, texts of 1025 to 8192 symbols on the cluster kernel included
(in_len on and one past a slice boundary, B 1 and 16, a log-attention
that starts 4 bytes past 16) and texts of 8193 to 16385 in panels (in_len
inside the first panel, on a panel boundary and one past it), and its
layout query against ``ops/mas.py``'s constants; CTC loss within relative
1e-5 and its gradient within max-abs 1e-5, at S 2049 to 16383 on the
cluster chains too (B 1 to 16), in panels at S 16385 to 24001 its rows
and loss bit for bit, and their layout query against ``ops/ctc.py``'s
constants; a launch given another layout than the kernels were built for
raises; kernel A as the op ``fs2t::attention_fwd`` through
``torch.library.opcheck``, and a one-layer Conformer exported with
``torch.export``, saved, loaded and run, launching A and equal to eager;
A with A' (at dh 128; at 96, 160, 192, 256, 384, 512 and 768 in f32 and
bf16), B, and C's loss forward and backward each captured in a CUDA graph
and replayed on new seeds or inputs, equal to their eager launches (bf16
dQ element by element as between two launches);
a tiny f32 train step captured by ``TrainStepGraph`` against the eager
step. Each counts one launch per kernel launch (a replay its capture's
launches), and each wrapper raises on an
input its kernel does not take. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import ctypes
import math
import re

import numpy as np
import pytest
import torch

from fastspeech2_lightning_tpu_torch.kernels import build
from fastspeech2_lightning_tpu_torch.ops import attention, ctc, mas, vocoder_resblocks
from fastspeech2_lightning_tpu_torch.ops.attention import (
    attention_bwd,
    attention_bwd_reference,
    attention_dropout_reference,
    attention_fwd,
    attention_reference,
    attention_with_dropout,
    dropout_keep_mask,
    kv_end,
)
from fastspeech2_lightning_tpu_torch.ops.ctc import (
    ctc_alpha,
    ctc_alpha_beta,
    ctc_alpha_reference,
    ctc_beta_reference,
    ctc_forward_sum,
    ctc_grad,
    ctc_grad_reference,
)
from fastspeech2_lightning_tpu_torch.ops.mas import (
    backtrack_window,
    mas_width1,
    mas_width1_reference,
)
from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import (
    ACCUMULATE,
    FINISH,
    WRITE,
    fused_mrf_stage,
    mrf_conv,
    mrf_conv_reference,
    mrf_route,
    mrf_stage,
    mrf_stage_reference,
    mrf_stage_supported,
    prepare_stage_weights,
    split_bf16,
)

C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_params(source: str, entry: str) -> list:
    text = (build.CSRC_DIR / f"{source}.cu").read_text()
    m = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', text, re.S)
    assert m, f"no extern C entry {entry} in {source}.cu"
    out = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            out.append(ctypes.c_void_p)
        else:
            out.append(C_TYPES[decl.rsplit(" ", 1)[0].replace("const ", "")])
    return out


@pytest.mark.parametrize("source,entry,argtypes", [
    ("attention_fwd", "attention_fwd", attention._FWD_ARGTYPES),
    ("attention_fwd", "attention_fwd_column_groups",
     attention._FWD_ENTRIES["attention_fwd_column_groups"]),
    ("attention_bwd", "attention_bwd", attention._BWD_ARGTYPES),
    ("attention_bwd", "attention_bwd_column_groups",
     attention._BWD_ENTRIES["attention_bwd_column_groups"]),
    ("mas_width1", "mas_width1", mas._ARGTYPES),
    ("mas_width1", "mas_width1_cluster_layout", mas._ENTRIES["mas_width1_cluster_layout"]),
    ("ctc_banded_lse", "ctc_alpha", ctc._ALPHA_ARGTYPES),
    ("ctc_banded_lse", "ctc_alpha_beta", ctc._ALPHA_BETA_ARGTYPES),
    ("ctc_banded_lse", "ctc_cluster_layout", ctc._LAYOUT_ARGTYPES),
    ("ctc_banded_lse", "ctc_cluster_limits", ctc._SIGNATURES["ctc_cluster_limits"]),
    ("ctc_banded_lse", "ctc_grad", ctc._GRAD_ARGTYPES),
    ("mrf_conv", "mrf_conv", vocoder_resblocks._ARGTYPES),
    ("mrf_stage", "mrf_stage", vocoder_resblocks._STAGE_ARGTYPES),
])
def test_c_entries_match_declared_argtypes(source, entry, argtypes):
    assert _c_params(source, entry) == list(argtypes)


def test_every_source_is_built_for_sm_90a():
    assert build.all_sources() == ["attention_bwd", "attention_fwd", "ctc_banded_lse",
                                   "mas_width1", "mrf_conv", "mrf_stage"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_variant_macros_default_in_the_sources():
    """Every -D macro tools/cluster_chain_variants.py builds a variant with
    is one a kernel source (or header) defines with a default, so that the
    default build is the kernels' own; a build with macros is a library of
    its own."""
    tool = (build.CSRC_DIR.parents[1] / "tools" / "cluster_chain_variants.py").read_text()
    macros = set(re.findall(r"-D(FS2T_[A-Z0-9_]+)=", tool))
    assert len(macros) == 7
    sources = "".join(p.read_text() for p in sorted(build.CSRC_DIR.glob("*.cu*")))
    for name in macros:
        assert re.search(rf"#ifndef {name}\n#define {name} ", sources), name
    assert build.lib_path("ctc_banded_lse") != build.lib_path(
        "ctc_banded_lse", ("-DFS2T_CTC_COPY_WARPS=2",))


def test_wrappers_raise_on_a_device_without_kernel():
    q = torch.empty(1, 2, 8, 64, device="meta")
    bias = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_fwd(q, q, q, bias, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        attention_bwd(q, q, q, bias, None, 0.0, 0.125, q, torch.empty(1, 2, 8, device="meta"), q)
    with pytest.raises(ValueError, match="unsupported device"):
        attention_with_dropout(q, q, q, bias, None, 0.0, 0.125)
    la = torch.empty(1, 8, 4, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mas_width1(la, lens, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_alpha(la, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_alpha_beta(la, lens, lens)
    rows = torch.empty(1, 8, 9, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_grad(rows, rows, lens, lens.float(), lens.float())
    x = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mrf_conv(x, torch.empty(3, 16, 16, device="meta"), torch.empty(16, device="meta"), 1,
                 out=torch.empty_like(x))


def _bias(valid):
    return torch.where(torch.as_tensor(valid), 0.0, attention.NEG_INF).float()


def _segments(T, *ranges):
    """[T] bool, True on the given [start, stop) ranges."""
    valid = np.zeros(T, bool)
    for start, stop in ranges:
        valid[start:stop] = True
    return valid


KV_END_CASES = {
    "full": (_segments(100, (0, 100)), 100),
    "ragged": (_segments(100, (0, 37)), 37),
    "no_valid_key": (_segments(100), 100),
    "hole": (_segments(100, (0, 10), (50, 60)), 60),
    "hole_at_start": (_segments(100, (70, 80)), 80),
    "T_not_a_tile_multiple": (_segments(37, (0, 5), (36, 37)), 37),
}


@pytest.mark.parametrize("case", list(KV_END_CASES))
def test_kv_end_is_one_past_the_last_valid_key(case):
    valid, want = KV_END_CASES[case]
    other = np.arange(valid.size) < 3  # a second item, so rows are not mixed up
    ends = kv_end(_bias(np.stack([valid, other])))
    assert ends.dtype == torch.int32 and ends.tolist() == [want, 3]


def test_rows_aligned_accepts_fused_views_and_refuses_offsets():
    qkv = torch.zeros(2, 40, 3, 2, 64, dtype=torch.bfloat16)
    assert all(attention._rows_aligned(qkv[:, :, i].transpose(1, 2)) for i in range(3))
    shifted = torch.zeros(2 * 2 * 40 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 2, 40, 64)
    assert not attention._rows_aligned(shifted)
    odd_stride = torch.zeros(2, 40, 2, 68, dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    assert not attention._rows_aligned(odd_stride)


def test_no_valid_key_rows_need_the_division_by_T():
    """An item with no valid key: m + log(l) rounds to m = -1e9 in f32, so
    exp(s - lse) is 1, not the plain version's 1/T; the backward kernels
    divide by T where lse < -5e8."""
    T, dh = 48, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, T, dh, generator=g) for _ in range(3))
    bias = _bias(np.zeros((1, T), bool))
    _, lse = attention_fwd(q, k, v, bias, 0.125, with_lse=True)
    assert float(lse.max()) < -5e8
    x = torch.matmul(q, k.transpose(-1, -2)) * 0.125 + bias[:, None, None, :]
    prob = torch.softmax(x, dim=-1)
    assert torch.equal(torch.exp(x - lse[..., None]), torch.ones_like(prob))
    torch.testing.assert_close(torch.exp(x - lse[..., None] - math.log(T)), prob,
                               rtol=1e-6, atol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float(torch.linalg.vector_norm(got.float() - want) / torch.linalg.vector_norm(want))


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


def _assert_dq_launches_agree(a, b, q, k, v, bias, seed, p, scale, do):
    """bf16 dQ of two A′ launches on the same inputs, element by element.
    Each launch adds the same f32 terms into an element, one from each key
    tile, by atomics in an order that varies, then rounds to bf16. Two
    orders of n f32 terms differ by at most 2 (n - 1) 2^-24 times the sum of
    their magnitudes, which sm_scale (|dS| |K|) bounds (n: T / 64 key tiles
    or fewer); the roundings add one bf16 step, at most 2^-7 of the
    larger."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    B, H, T, _ = q.shape
    prob = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                         + bias.float()[:, None, None, :], dim=-1)
    keep = dropout_keep_mask(int(seed.reshape(-1)[0]), B, H, T, p, device=q.device)
    dprob = torch.where(keep, torch.matmul(dof, vf.transpose(-1, -2)) / (1.0 - p), 0.0)
    ds = prob * (dprob - (prob * dprob).sum(-1, keepdim=True))
    terms = scale * torch.matmul(ds.abs(), kf.abs())
    reorder = 2 * (-(-T // 64) - 1) * 2.0 ** -24 * terms
    af, bf = a.float(), b.float()
    limit = 2.0 ** -7 * torch.maximum(af.abs(), bf.abs()) + reorder
    apart = (af - bf).abs() > limit
    assert not bool(apart.any()), (
        f"dQ of two launches apart at {int(apart.sum())} elements, the worst "
        f"{float(((af - bf).abs() - limit).max())} past its limit")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,dh", [(3, 2, 37, 64), (3, 2, 160, 128), (2, 2, 1000, 128),
                                      (8, 4, 160, 64), (2, 2, 65, 192), (2, 1, 63, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_version(cuda, B, H, T, dh, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, H, T, dh, device=cuda, generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([T, max(T - 37, 1), 5] * B, device=cuda)[:B]
    bias = torch.where(torch.arange(T, device=cuda)[None] < lens[:, None], 0.0,
                       attention.NEG_INF).float()
    before = attention_fwd.launches
    out = attention_fwd(q, k, v, bias, 1.0 / math.sqrt(dh))
    torch.cuda.synchronize()
    assert attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = attention_reference(q.float(), k.float(), v.float(), bias, 1.0 / math.sqrt(dh))
    assert _rel(out, want) <= _tol(dtype)


@pytest.mark.gpu
def test_attention_kernel_takes_strided_views_and_refuses_other_head_dims(cuda):
    """Strided views of the fused projection; dh 32 runs padded to 64 and
    dh 320 padded to 384 (one launch each); the launch itself refuses a
    head dim the kernels are not built for."""
    B, T, H, dh = 2, 70, 2, 64
    qkv = torch.randn(B, T, 3, H, dh, device=cuda)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.zeros(B, T, device=cuda)
    out = attention_fwd(q, k, v, bias, 0.125)
    want = attention_reference(q, k, v, bias, 0.125)
    assert _rel(out, want) <= 1e-5
    before = attention_fwd.launches
    for width in (32, 320):
        x = torch.randn(1, 2, 16, width, device=cuda)
        out = attention_fwd(x, x, x, torch.zeros(1, 16, device=cuda), 0.125)
        want = attention_reference(x, x, x, torch.zeros(1, 16, device=cuda), 0.125)
        assert out.shape == x.shape and _rel(out, want) <= 1e-5
    assert attention_fwd.launches == before + 2
    x = torch.randn(1, 2, 16, 320, device=cuda)
    with pytest.raises(ValueError, match="head dim 320"):
        attention._launch_fwd(x, x, x, torch.zeros(1, 16, device=cuda), 0.125, 0.0, None, False)
    assert attention_fwd.launches == before + 2


# items of one batch for the masks the tile skipping must get right; at
# T = 400 every item but the one with no valid key (which keeps every tile)
# leaves whole key tiles past kv_end
EDGE_MASKS = {
    "no_valid_key": [_segments(200), _segments(200, (0, 150)), _segments(200, (0, 200))],
    "hole": [_segments(200, (0, 40), (90, 170)), _segments(200, (130, 140)),
             _segments(200, (0, 64), (127, 129))],
    "tile_edges": [_segments(200, (0, n)) for n in (63, 64, 65, 127, 128, 129)],
    "skipped_tiles": ([_segments(400, (0, n)) for n in (1, 63, 64, 65, 127, 128, 129, 200)]
                      + [_segments(400), _segments(400, (0, 40), (90, 170)),
                         _segments(400, (130, 140))]),
}


def _check_fwd_bwd(cuda, q, k, v, bias, dtype, p, ref_kv=None, offsets=None):
    """Both kernels against the plain version in f32 on the same inputs
    (or on `ref_kv` in place of k and v), the same seed (so the same dropout
    mask); with `offsets` (row_offset, head_offset, heads_total) A by its
    launch at those offsets and its log-sum-exp against the plain one too:
    within 1e-5 (f32 exponentials and sums in another order; relative 1e-6
    where an item with no valid key sits at -1e9)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    do = torch.randn(q.shape, device=cuda, generator=g).to(dtype)
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda)
    scale = 1.0 / math.sqrt(q.shape[-1])
    offs = offsets or (0, 0, None)
    if offsets is None:
        out, lse = attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)
    else:
        out, lse = attention.padded_fwd(attention._launch_fwd, q, k, v, bias, scale, p,
                                        seed if p > 0 else None, True, *offs)
    grads = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do, *offs)
    torch.cuda.synchronize()
    k, v = ref_kv or (k, v)
    qf, kf, vf = q.float(), k.float(), v.float()
    assert _rel(out, attention_dropout_reference(qf, kf, vf, bias, seed, p, scale,
                                                 *offs)) <= _tol(dtype)
    if offsets is not None:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias[:, None, None, :]
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-5)
    want = attention_bwd_reference(qf, kf, vf, bias, seed, p, scale, do.float(), *offs)
    for got, ref, other in zip(grads, want, (kf, qf, None)):
        assert got.dtype == dtype
        if q.shape[2] == 1 and other is not None:
            # one key: P = 1, so dS = keep dP / (1 - p) - D is 0 in exact
            # arithmetic and dQ, dK with it; the kernels take D from the
            # output as rounded to its dtype, so dS cancels only to the
            # rounding of its terms (a relative error of ~0 means nothing)
            terms = float((do.float() * vf).abs().sum(-1).max()) / (1.0 - p)
            limit = _tol(dtype) * scale * terms * float(other.abs().max())
            assert float(got.float().abs().max()) <= limit
        else:
            assert _rel(got, ref) <= _tol(dtype)
    return grads


def _fused_qkv(cuda, B, T, H, dh, dtype, seed=0):
    """q, k, v as the conformer passes them: strided [B, H, T, dh] views of
    one [B, T, 3, H, dh] projection."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, dh, device=cuda, generator=g).to(dtype)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


WIDEST_KEY_TILE = 128  # the bf16 backward's; the other kernels' tiles divide it


def _poison_past_kv_end(k, v, bias) -> tuple:
    """Write NaN, in place, into every key and value of a tile that lies
    wholly past kv_end for every kernel (from kv_end rounded up to the widest
    key tile); returns clean copies of k and v and how many keys per head
    were poisoned. The bias is additive, so a kernel that read such a tile
    would turn its outputs NaN."""
    clean = k.clone(), v.clone()
    poisoned = 0
    for b, end in enumerate(kv_end(bias.cpu()).tolist()):
        start = -(-end // WIDEST_KEY_TILE) * WIDEST_KEY_TILE
        k[b, :, start:] = float("nan")
        v[b, :, start:] = float("nan")
        poisoned += max(k.shape[2] - start, 0)
    return clean, poisoned


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EDGE_MASKS))
@pytest.mark.parametrize("dh", [64, 128, 129, 160, 192, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_attention_kernels_on_mask_edges(cuda, case, dh, dtype, p):
    """Both kernels against the plain version on clean inputs, with NaN in
    the keys and values of every tile past kv_end: the kernels must skip
    those tiles (and the device's kv_end must not lie past the plain
    kv_end) for the outputs to match."""
    bias = _bias(np.stack(EDGE_MASKS[case])).to(cuda)
    q, k, v = _fused_qkv(cuda, bias.shape[0], bias.shape[1], 2, dh, dtype)
    clean, poisoned = _poison_past_kv_end(k, v, bias)
    if case == "skipped_tiles":
        assert poisoned == 6 * (400 - 128) + 4 * (400 - 256)
    _check_fwd_bwd(cuda, q, k, v, bias, dtype, p, ref_kv=clean)


OFFSETS = {"default": (0, 0, None), "rank": (3, 1, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", list(OFFSETS))
@pytest.mark.parametrize("dh", [64, 128, 192, 256, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_draw_the_mask_at_their_offsets(cuda, offsets, dh, dtype):
    """The keep mask each kernel applies, read back bit for bit: with q = k
    = 0 every kept probability is 1 / (T (1 - p)) and a dropped one 0, so
    with one-hot values (T = dh) the forward's output row i is row i of the
    mask, and with one-hot output gradients A′'s dV is its transpose. At a
    rank's (row_offset, head_offset, heads_total) it is that block of the
    global mask; at the defaults it is the mask of one process as before."""
    B, H, T, p = 2, 2, dh, 0.3
    row_offset, head_offset, heads_total = OFFSETS[offsets]
    eye = torch.eye(T, device=cuda, dtype=dtype).expand(B, H, T, T).contiguous()
    zero = torch.zeros(B, H, T, dh, device=cuda, dtype=dtype)
    bias = torch.zeros(B, T, device=cuda)
    seed = torch.tensor([-99], dtype=torch.int32, device=cuda)
    o, lse = attention._launch_fwd(zero, zero, eye, bias, 0.125, p, seed, True, row_offset,
                                   head_offset, heads_total)
    _, _, dv = attention_bwd(zero, zero, eye, bias, seed, p, 0.125, o, lse, eye, row_offset,
                             head_offset, heads_total)
    torch.cuda.synchronize()
    want = dropout_keep_mask(-99, B, H, T, p, device=cuda, row_offset=row_offset,
                             head_offset=head_offset, heads_total=heads_total)
    assert torch.equal(o != 0, want)
    assert torch.equal(dv != 0, want.transpose(-1, -2))
    if offsets == "default":
        assert torch.equal(want, dropout_keep_mask(-99, B, H, T, p, device=cuda))
    else:  # the block of the mask of the global [B + 3 + ..., 4] batch
        whole = dropout_keep_mask(-99, B + row_offset, heads_total, T, p, device=cuda)
        assert torch.equal(want, whole[row_offset:, head_offset:head_offset + H])


@pytest.mark.gpu
@pytest.mark.parametrize("T", [37, 1000])
@pytest.mark.parametrize("dh", [64, 160, 192, 256, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_offsets_match_plain_version(cuda, T, dh, dtype):
    """The training Function (A forward, A′ backward) at nonzero offsets
    against autograd through the plain version at the same offsets."""
    B, H, p = 2, 2, 0.2
    offsets = (5, 2, 6)
    lens = [T, max(T - 37, 1)]
    bias = _bias(np.stack([_segments(T, (0, n)) for n in lens])).to(cuda)
    q, k, v = (t.detach().requires_grad_(True) for t in _fused_qkv(cuda, B, T, H, dh, dtype))
    do = torch.randn(q.shape, device=cuda, generator=torch.Generator(device=cuda)
                     .manual_seed(2)).to(dtype)
    seed = torch.tensor([777], dtype=torch.int32, device=cuda)
    before = (attention_fwd.launches, attention_bwd.launches)
    out = attention_with_dropout(q, k, v, bias, seed, p, 0.125, *offsets)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = attention_dropout_reference(qf, kf, vf, bias, seed, p, 0.125, *offsets)
    assert _rel(out, want) <= _tol(dtype)
    for got, ref in zip(grads, torch.autograd.grad(want, (qf, kf, vf), do.float())):
        assert _rel(got, ref) <= _tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 37, 63, 65, 1000, 1100, 2047])
@pytest.mark.parametrize("dh", [64, 128, 160, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_attention_kernels_on_T_off_the_tiles(cuda, T, dh, dtype, p):
    lens = [T, max(T - 37, 1)]
    bias = _bias(np.stack([_segments(T, (0, n)) for n in lens])).to(cuda)
    q, k, v = _fused_qkv(cuda, 2, T, 2, dh, dtype, seed=T)
    _check_fwd_bwd(cuda, q, k, v, bias, dtype, p)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [1, 16, 24, 32, 48, 96, 129, 160, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_attention_kernels_at_padded_head_dims(cuda, dh, dtype, p):
    """A dh the kernels are not built for runs zero-padded to the next
    build, one launch of each kernel, FLOPs counted at the true dh, the
    gradients sliced back to [B, H, T, dh]; q, k, v as fused views."""
    T = 300
    bias = _bias(np.stack([_segments(T, (0, n)) for n in (T, 171)])).to(cuda)
    q, k, v = _fused_qkv(cuda, 2, T, 2, dh, dtype, seed=dh)
    f0, b0, flops0 = attention_fwd.launches, attention_bwd.launches, attention_bwd.flops
    grads = _check_fwd_bwd(cuda, q, k, v, bias, dtype, p)
    assert (attention_fwd.launches, attention_bwd.launches) == (f0 + 1, b0 + 1)
    assert attention_bwd.flops - flops0 == attention.attention_bwd_flops(2, 2, T, dh)
    assert all(g.shape == q.shape and g.is_contiguous() for g in grads)


# kernel A's bf16 kernels above dh 128: attention_fwd_tc_pair at 129-256
# (padded to 192 or 256), attention_fwd_tc_split at 257-768 (padded to a
# multiple of 128)
PAIR_AND_SPLIT_HEAD_DIMS = [160, 192, 200, 256, 257, 320, 384, 512, 768]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", PAIR_AND_SPLIT_HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 63, 65, 127, 129, 1000])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("offsets", list(OFFSETS))
def test_attention_above_dh_128_against_plain_version(cuda, dh, T, p, offsets):
    """A in bf16 above dh 128 (two warpgroups on shared K and V tiles to
    256; each score once, the columns split, above) on a batch of a full
    mask, a ragged one and an item with no valid key, at T off the 64- and
    128-row tiles, at the default and at a rank's (row, head) offsets: its
    output and log-sum-exp against the plain version, and A′ fed that
    log-sum-exp against autograd through the plain version. At p 0 no bit
    is drawn: the launch with a seed and the log-sum-exp equals the launch
    without either, bit for bit."""
    B, H = 3, 2
    bias = _bias(np.stack([_segments(T, (0, n)) for n in (T, max(T - 37, 1), 0)])).to(cuda)
    q, k, v = _fused_qkv(cuda, B, T, H, dh, torch.bfloat16, seed=dh + T)
    _check_fwd_bwd(cuda, q, k, v, bias, torch.bfloat16, p, offsets=OFFSETS[offsets])
    if p == 0.0:
        seed = torch.tensor([4321], dtype=torch.int32, device=cuda)
        with_seed, _ = attention_fwd(q, k, v, bias, 0.1, p=0.0, seed=seed, with_lse=True)
        assert torch.equal(with_seed, attention_fwd(q, k, v, bias, 0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("H,dh", [(1, 64), (2, 192)])
def test_attention_past_the_dropout_limit_at_p0(cuda, H, dh):
    """T 65600 at p 0, where no dropout bit is drawn, on a batch of one item
    whose 65600 keys are all valid (key tiles past 65536 are read) and one
    whose last 1000 are masked: A and A′ launch once each, their outputs are
    finite, and they equal the plain version's in f32, A on slices of query
    rows (a row's output depends on its own query alone), A′'s dQ on the
    same rows and its dK, dV on slices of keys against autograd through the
    plain version over every row, 2048 rows at a time (at p 0.2:
    ``test_attention_dropout_past_65536_frames``)."""
    T, chunk = 65600, 2048
    g = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v, do = (torch.randn(2, H, T, dh, device=cuda, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    bias = torch.zeros(2, T, device=cuda)
    bias[1, T - 1000:] = attention.NEG_INF
    scale = 1.0 / math.sqrt(dh)
    before = attention_fwd.launches, attention_bwd.launches
    out, lse = attention_fwd(q, k, v, bias, scale, with_lse=True)
    dq, dk, dv = attention_bwd(q, k, v, bias, None, 0.0, scale, out, lse, do)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))
    kf, vf = (t.float().requires_grad_(True) for t in (k, v))
    rows = ((0, 256), (32768, 33024), (T - 64, T))  # each within one chunk
    for r0 in range(0, T, chunk):
        qc = q[:, :, r0:r0 + chunk].float().requires_grad_(True)
        want = attention_reference(qc, kf, vf, bias, scale)
        want.backward(do[:, :, r0:r0 + chunk].float())
        want = want.detach()
        for a, b in rows:
            if r0 <= a < r0 + chunk:
                assert _rel(out[:, :, a:b], want[:, :, a - r0:b - r0]) <= _tol(torch.bfloat16)
                assert _rel(dq[:, :, a:b], qc.grad[:, :, a - r0:b - r0]) <= _tol(torch.bfloat16)
        del qc, want
    for a, b in ((0, 256), (32768, 33024), (T - 256, T)):
        assert _rel(dk[:, :, a:b], kf.grad[:, :, a:b]) <= _tol(torch.bfloat16)
        assert _rel(dv[:, :, a:b], vf.grad[:, :, a:b]) <= _tol(torch.bfloat16)


def _old_keep_mask(seed, B, H, rows, cols, p):
    """The keep mask as the hash drew it before it keyed on the full (row,
    col): (row << 16) | col in 32 bits, for rows and columns below 65536."""
    key = attention._mix32((seed & attention._M32) ^ attention._mix32(
        (attention._mul32(attention._stream_index(B, H, 0, 0, None, rows.device), 0x9E3779B9)
         + 0x632BE5AB) & attention._M32))
    cell = ((rows[:, None] << 16) | cols[None, :]) & attention._M32
    return (attention._mix32(cell[None] ^ key[:, None, None])
            >= attention.dropout_threshold(p)).view(B, H, len(rows), len(cols))


def _window_masks(cuda, T, c0, i0, p, dtype=torch.bfloat16):
    """The keep mask A and A′ draw, read back bit for bit at T: with q = k =
    0, keys [c0, c0 + 128) the only valid ones and V one-hot over them, A's
    output is the mask on those columns for every row; with dO one-hot over
    rows [i0, i0 + 128), A′'s dV is the mask on those rows for every valid
    key. Returns (A's [B, H, T, 128] != 0, A′'s [B, H, 128 rows, T keys]
    != 0 on the valid keys)."""
    B, H, W = 1, 2, 128
    seed = torch.tensor([-99], dtype=torch.int32, device=cuda)
    zero = torch.zeros(B, H, T, W, device=cuda, dtype=dtype)
    onehot = torch.zeros(B, H, T, W, device=cuda, dtype=dtype)
    onehot[:, :, c0:c0 + W] = torch.eye(W, device=cuda, dtype=dtype)
    bias = torch.full((B, T), attention.NEG_INF, device=cuda)
    bias[:, c0:c0 + W] = 0.0
    o, lse = attention_fwd(zero, zero, onehot, bias, 0.125, p=p, seed=seed, with_lse=True)
    do = torch.zeros(B, H, T, W, device=cuda, dtype=dtype)
    do[:, :, i0:i0 + W] = torch.eye(W, device=cuda, dtype=dtype)
    _, _, dv = attention_bwd(zero, zero, onehot, bias, seed, p, 0.125, o, lse, do)
    torch.cuda.synchronize()
    return o != 0, (dv[:, :, c0:c0 + W] != 0).transpose(-1, -2)


@pytest.mark.gpu
def test_dropout_masks_below_65536_frames_keep_the_old_hash(cuda):
    """At T 65536 the masks A and A′ draw equal, bit for bit, those of the
    hash as it was before it keyed on the full (row, col) (a copy of the
    old formula), on the key columns and query rows next to 65535 and at
    the start; at T 65600 the columns and rows across 65536 equal
    ``dropout_keep_mask``'s, and differ from the old formula's wrapped
    cells."""
    T, W, p = 1 << 16, 128, 0.2
    dev_rows = torch.arange(T, dtype=torch.int64, device=cuda)
    for c0 in (0, T - W):
        cols = torch.arange(c0, c0 + W, dtype=torch.int64, device=cuda)
        fwd, bwd = _window_masks(cuda, T, c0, c0, p)
        assert torch.equal(fwd, _old_keep_mask(-99, 1, 2, dev_rows, cols, p))
        assert torch.equal(bwd, _old_keep_mask(-99, 1, 2, cols, cols, p))
    T = 65600
    c0 = (1 << 16) - 64  # the window crosses 65536
    fwd, bwd = _window_masks(cuda, T, c0, c0, p)
    assert torch.equal(fwd, dropout_keep_mask(-99, 1, 2, T, p, device=cuda, cols=(c0, c0 + W)))
    assert torch.equal(bwd, dropout_keep_mask(-99, 1, 2, T, p, device=cuda, rows=(c0, c0 + W),
                                              cols=(c0, c0 + W)))
    # the old packing's cells past 65536 wrapped onto others
    old = _old_keep_mask(-99, 1, 2, torch.arange(T, dtype=torch.int64, device=cuda),
                         torch.arange(c0, c0 + W, dtype=torch.int64, device=cuda), p)
    assert not torch.equal(fwd[:, :, (1 << 16):], old[:, :, (1 << 16):])


def _dropout_rows(q, k, v, bias, seed, p, scale, r0):
    """The plain version with dropout on query rows [r0, r0 + rows) of q's
    slice `q` against every key (rows are independent): f32."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    prob = torch.softmax(s, dim=-1)
    B, H, n, T = prob.shape
    keep = dropout_keep_mask(int(seed), B, H, T, p, device=q.device, rows=(r0, r0 + n))
    return torch.matmul(torch.where(keep, prob / (1.0 - p), 0.0), v)


@pytest.mark.gpu
def test_attention_dropout_past_65536_frames(cuda):
    """A and A′ at (1, 2, 65600, 128), p 0.2, every key valid: one launch
    each, finite, and against the plain version in f32 (``_dropout_rows``,
    2048 query rows at a time through autograd) on slices of query rows
    (A's output and A′'s dQ) and of keys (dK, dV) at the start, across
    65536 and at the end, within the bf16 tolerance of the other dropout
    holds."""
    T, dh, p = 65600, 128, 0.2
    g = torch.Generator(device=cuda).manual_seed(65)
    q, k, v, do = (torch.randn(1, 2, T, dh, device=cuda, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    bias = torch.zeros(1, T, device=cuda)
    seed = torch.tensor([2023], dtype=torch.int32, device=cuda)
    scale = 1.0 / math.sqrt(dh)
    before = attention_fwd.launches, attention_bwd.launches
    out, lse = attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)
    dq, dk, dv = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv))
    kf, vf = (t.float().requires_grad_(True) for t in (k, v))
    spans = ((0, 256), (65472, 65600), (65536 - 128, 65536 + 64))
    bounds = list(range(0, 65408, 2048)) + [65408, T]  # each span within one chunk
    for r0, r1 in zip(bounds, bounds[1:]):
        qc = q[:, :, r0:r1].float().requires_grad_(True)
        want = _dropout_rows(qc, kf, vf, bias, 2023, p, scale, r0)
        want.backward(do[:, :, r0:r1].float())
        want = want.detach()
        for a, b in spans:
            if r0 <= a and b <= r1:
                assert _rel(out[:, :, a:b], want[:, :, a - r0:b - r0]) <= _tol(torch.bfloat16)
                assert _rel(dq[:, :, a:b], qc.grad[:, :, a - r0:b - r0]) <= _tol(torch.bfloat16)
        del qc, want
    for a, b in spans:
        assert _rel(dk[:, :, a:b], kf.grad[:, :, a:b]) <= _tol(torch.bfloat16)
        assert _rel(dv[:, :, a:b], vf.grad[:, :, a:b]) <= _tol(torch.bfloat16)


@pytest.mark.gpu
def test_fwd_column_groups_follow_the_group_width(cuda):
    """A's column groups as its C entry routes them: one up to dh 256 and,
    in bf16, up to 768 (each score once); above, groups of 256 where 256
    divides the padded dh, else of 128 (always 128 in f32)."""
    want = {64: 1, 160: 1, 256: 1, 257: 1, 384: 1, 512: 1, 640: 1, 768: 1, 896: 7, 1024: 4}
    assert {dh: attention.fwd_column_groups(dh) for dh in want} == want
    assert attention.fwd_column_groups(384, torch.float32) == 3


@pytest.mark.gpu
def test_bwd_column_groups_follow_the_group_width(cuda):
    """A′'s column groups as its C entry routes them: one up to dh 256, then
    groups of 256 where 256 divides the padded dh, else of 192 in bf16,
    else of 128 (always 128 in f32)."""
    want = {64: 1, 160: 1, 256: 1, 257: 2, 384: 2, 512: 2, 640: 5, 768: 3}
    assert {dh: attention.bwd_column_groups(dh) for dh in want} == want
    assert attention.bwd_column_groups(384, torch.float32) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [257, 320, 384, 512, 640, 768, 769, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_attention_kernels_at_wide_head_dims(cuda, dh, dtype, p):
    """dh above 256 runs at the next multiple of 128: bf16 A in one block a
    query tile to 768 and above it (769 padded to 896, 1000 to 1024) one
    block a group of output columns (128 or 256 wide), A′ and the f32
    kernels in groups (128, 192 or 256 wide): ragged keys with NaN past
    kv_end, T off the tiles, one launch of each kernel, FLOPs at the true
    dh."""
    T = 300
    bias = _bias(np.stack([_segments(T, (0, n)) for n in (T, 171)])).to(cuda)
    q, k, v = _fused_qkv(cuda, 2, T, 1, dh, dtype, seed=dh)
    clean, poisoned = _poison_past_kv_end(k, v, bias)
    assert poisoned == T - 256
    f0, b0, flops0 = attention_fwd.launches, attention_bwd.launches, attention_bwd.flops
    grads = _check_fwd_bwd(cuda, q, k, v, bias, dtype, p, ref_kv=clean)
    assert (attention_fwd.launches, attention_bwd.launches) == (f0 + 1, b0 + 1)
    assert attention_bwd.flops - flops0 == attention.attention_bwd_flops(2, 1, T, dh)
    assert all(g.shape == q.shape for g in grads)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EDGE_MASKS))
@pytest.mark.parametrize("dh", [384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_wide_attention_kernels_on_mask_edges(cuda, case, dh, dtype, p):
    """The mask edges of ``test_attention_kernels_on_mask_edges`` at the
    wide head dims (A′'s groups of 192 and of 256 columns in bf16)."""
    bias = _bias(np.stack(EDGE_MASKS[case])).to(cuda)
    q, k, v = _fused_qkv(cuda, bias.shape[0], bias.shape[1], 1, dh, dtype)
    clean, _ = _poison_past_kv_end(k, v, bias)
    _check_fwd_bwd(cuda, q, k, v, bias, dtype, p, ref_kv=clean)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 37, 63, 65, 1000, 1100, 2047])
@pytest.mark.parametrize("dh", [257, 384, 512, 768, 769, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_attention_kernels_on_T_off_the_tiles(cuda, T, dh, dtype):
    lens = [T, max(T - 37, 1)]
    bias = _bias(np.stack([_segments(T, (0, n)) for n in lens])).to(cuda)
    q, k, v = _fused_qkv(cuda, 2, T, 1, dh, dtype, seed=T)
    _check_fwd_bwd(cuda, q, k, v, bias, dtype, 0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [384, 512, 768, 896, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_attention_kernels_draw_one_mask_across_column_groups(cuda, dh, dtype):
    """With q = k = 0 and one-hot values (T = dh) the forward's output is
    the keep mask, each column group of blocks writing its own columns, and
    A′'s dV (one-hot output gradients) its transpose: read back bit for bit,
    the groups drew the same mask as one block over all columns would."""
    B, H, T, p = 1, 2, dh, 0.3
    eye = torch.eye(T, device=cuda, dtype=dtype).expand(B, H, T, T).contiguous()
    zero = torch.zeros(B, H, T, dh, device=cuda, dtype=dtype)
    bias = torch.zeros(B, T, device=cuda)
    seed = torch.tensor([-99], dtype=torch.int32, device=cuda)
    o, lse = attention_fwd(zero, zero, eye, bias, 0.125, p=p, seed=seed, with_lse=True)
    _, _, dv = attention_bwd(zero, zero, eye, bias, seed, p, 0.125, o, lse, eye)
    torch.cuda.synchronize()
    want = dropout_keep_mask(-99, B, H, T, p, device=cuda)
    assert torch.equal(o != 0, want)
    assert torch.equal(dv != 0, want.transpose(-1, -2))
    torch.testing.assert_close(lse, torch.full_like(lse, math.log(T)))

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_zeroes_dk_dv_past_kv_end(cuda, dtype):
    """Item 0 keeps 65 of 300 keys: its keys from 128 on (NaN here) lie in
    tiles past kv_end (65) for every kernel's tile width, and its dK, dV are
    exactly 0 from 65 on."""
    bias = _bias(np.stack([_segments(300, (0, 65)), _segments(300, (0, 300))])).to(cuda)
    assert kv_end(bias).tolist() == [65, 300]
    q, k, v = _fused_qkv(cuda, 2, 300, 2, 64, dtype)
    clean, poisoned = _poison_past_kv_end(k, v, bias)
    assert poisoned == 300 - 128
    _, dk, dv = _check_fwd_bwd(cuda, q, k, v, bias, dtype, 0.2, ref_kv=clean)
    for grad in (dk, dv):
        assert torch.count_nonzero(grad[0, :, 65:]) == 0
        assert torch.count_nonzero(grad[1, :, 128:]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [160, 192, 256, 384, 512])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_bf16_backward_dk_dv_are_deterministic(cuda, dh, p):
    """Two launches of A′ in bf16 on the same inputs (ragged keys, T off the
    tiles) give the same dK and dV bit for bit: each block sums its keys'
    dK and dV over the query tiles in one order, whichever warpgroup owns a
    column. dQ is summed across key tiles by atomics, so each element of the
    two launches' dQ differs by at most one bf16 rounding step and what
    reordering its f32 sum can move it (``_assert_dq_launches_agree``), and
    each stays within the plain version's limit."""
    T = 1100
    bias = _bias(np.stack([_segments(T, (0, n)) for n in (T, 777)])).to(cuda)
    q, k, v = _fused_qkv(cuda, 2, T, 2, dh, torch.bfloat16, seed=dh)
    do = torch.randn(q.shape, device=cuda, generator=torch.Generator(device=cuda)
                     .manual_seed(9)).to(torch.bfloat16)
    seed = torch.tensor([2024], dtype=torch.int32, device=cuda)
    scale = 1.0 / math.sqrt(dh)
    out, lse = attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)
    first = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)
    second = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    _assert_dq_launches_agree(first[0], second[0], q, k, v, bias, seed, p, scale, do)
    want = attention_bwd_reference(q.float(), k.float(), v.float(), bias, seed, p, scale,
                                   do.float())
    for grads in (first, second):
        for got, ref in zip(grads, want):
            assert _rel(got, ref) <= _tol(torch.bfloat16)


def test_poisoned_key_tiles_turn_a_reader_nan():
    """The poison of the card tests has teeth: the plain version, which
    reads every key, turns NaN on each item with poisoned keys, while
    attention over the keys before the poison (what a kernel that skips
    those tiles computes) equals the plain version on clean inputs."""
    T = 400
    bias = _bias(np.stack(EDGE_MASKS["skipped_tiles"]))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(len(bias), 2, T, 64, generator=g) for _ in range(3))
    (k_clean, v_clean), _ = _poison_past_kv_end(k, v, bias)
    read_all = attention_reference(q, k, v, bias, 0.125)
    want = attention_reference(q, k_clean, v_clean, bias, 0.125)
    for b, end in enumerate(kv_end(bias).tolist()):
        start = -(-end // WIDEST_KEY_TILE) * WIDEST_KEY_TILE
        assert bool(read_all[b].isnan().all()) == (start < T)
        cut = slice(b, b + 1), slice(None), slice(0, start)
        skipped = attention_reference(q[b:b + 1], k[cut], v[cut], bias[b:b + 1, :start], 0.125)
        torch.testing.assert_close(skipped, want[b:b + 1])


@pytest.mark.gpu
def test_bf16_attention_refuses_unaligned_rows(cuda):
    x = torch.randn(1, 2, 16, 68, device=cuda, dtype=torch.bfloat16)[..., 1:65]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        attention_fwd(x, x, x, torch.zeros(1, 16, device=cuda), 0.125)


KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


def _stage_blocks(C, device, seed=1, ks=KS, dils=DILS):
    """One stage's resblocks (a V1 stage's by default) in torch Conv1d
    layout, fan-in scaled."""
    g = torch.Generator(device=device).manual_seed(seed)
    blocks = []
    for k, ds in zip(ks, dils):
        p = {}
        for i in range(len(ds)):
            for name in ("convs1", "convs2"):
                p[f"{name}.{i}.weight"] = (torch.randn(C, C, k, device=device, generator=g)
                                           / math.sqrt(k * C))
                p[f"{name}.{i}.bias"] = 0.1 * torch.randn(C, device=device, generator=g)
        blocks.append(p)
    return blocks


def _mrf_tol(dtype):
    """f32 inputs are multiplied as bf16 pairs (a_hi w_hi + a_lo w_hi +
    a_hi w_lo, the term a_lo w_lo dropped), which keeps 16 bits of each
    factor: about 1e-5 a conv, within 5e-5 over a stage."""
    return 5e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_split_bf16_rebuilds_f32_weights(scale):
    g = torch.Generator().manual_seed(0)
    w = scale * torch.randn(11, 64, 64, generator=g)
    pair = split_bf16(w)
    assert pair.dtype == torch.bfloat16 and pair.shape == (2, 11, 64, 64)
    rebuilt = pair[0].float() + pair[1].float()
    assert float(((rebuilt - w).abs() / w.abs()).max()) <= 2.0 ** -16
    assert torch.equal(pair[0], w.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_on_prepared_weights_equals_stage_reference(dtype):
    """The stage wrapper on CPU tensors runs each conv's plain version on the
    weights as the kernel gets them: bf16 [K, C, C], or the (hi, lo) pair for
    f32, which must give the unfused f32 stage back."""
    C = 32
    blocks = _stage_blocks(C, "cpu")
    x = torch.randn(2, 150, C, generator=torch.Generator().manual_seed(2)).to(dtype)
    flat = prepare_stage_weights(blocks, KS, DILS, dtype)
    assert len(flat) == 36 and all(w.dtype == torch.bfloat16 for w in flat[0::2])
    assert flat[0].shape == ((2, 3, C, C) if dtype == torch.float32 else (3, C, C))
    assert all(b.dtype == dtype and b.shape == (C,) for b in flat[1::2])
    got = fused_mrf_stage(x, flat, KS, DILS)
    ref_blocks = [{n: w.to(dtype).float() for n, w in p.items()} for p in blocks]
    want = mrf_stage_reference(x.float(), ref_blocks, KS, DILS)
    assert got.dtype == dtype
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("C,ks,dils,want", [
    (128, KS, DILS, True), (64, KS, DILS, True), (32, KS, DILS, True),
    (16, KS, DILS, True), (8, KS, DILS, True), (96, KS, DILS, True),
    (256, KS, DILS, False), (129, KS, DILS, False),
    (64, (4, 7, 11), DILS, True), (64, (3, 7, 13), DILS, False),
    (64, (3,), ((1, 26),), True), (64, (7,), ((1, 3, 9),), True), (64, (3,), ((63,),), True),
    (64, (3,), ((64,),), False), (64, (2,), ((200,),), False),
])
def test_mrf_stage_gate_names_what_the_kernel_takes(C, ks, dils, want):
    assert mrf_stage_supported(C, ks, dils) is want


def test_mrf_conv_raises_when_x_aliases_out():
    x = torch.zeros(1, 8, 32)
    w, bias = torch.zeros(3, 32, 32), torch.zeros(32)
    with pytest.raises(ValueError, match="must not alias"):
        mrf_conv(x, w, bias, 1, out=x)
    with pytest.raises(ValueError, match="must not alias"):
        mrf_conv(x, w, bias, 1, out=x.view(8, 1, 32).view(1, 8, 32))
    out = torch.empty_like(x)
    mrf_conv(x, w, bias, 1, residual=out.zero_(), out=out)  # residual may be out


@pytest.mark.parametrize("grad_of", ["x", "weight"])
def test_mrf_kernel_refuses_autograd(grad_of):
    """The MRF kernel has no backward: with grad mode on and an input that
    requires grad, the stage and the conv raise (on the CPU through the
    wrapper's dispatch to the plain version) instead of returning outputs
    without a gradient; under no_grad the same call runs."""
    C = 32
    blocks = _stage_blocks(C, "cpu")
    x = torch.randn(1, 40, C, generator=torch.Generator().manual_seed(1))
    flat = prepare_stage_weights(blocks, KS, DILS, torch.float32)
    if grad_of == "x":
        x.requires_grad_(True)
    else:
        flat[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mrf_stage(x, flat, KS, DILS)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_conv(x, flat[0], flat[1], 1, out=torch.empty(1, 40, C))
    with torch.no_grad():
        out = fused_mrf_stage(x, flat, KS, DILS)
    assert out.shape == x.shape and not out.requires_grad


def _chunked_backtrack(words, in_len: int, out_len: int):
    """The kernel's backtrack in plain Python: `words[i][k]` is row i's
    decision word k; 32 rows at a time from (out_len - 1, in_len - 1), each
    row's window taken at the column the chunk starts from. Returns the
    path's column at every row 0 .. out_len - 1."""
    path = [0] * out_len
    c = in_len - 1
    for top in range(out_len - 1, -1, -32):
        windows = []
        for lane in range(32):
            i = top - lane
            hi = words[i][c >> 5] if i >= 1 else 0
            lo = words[i][(c >> 5) - 1] if i >= 1 and c >= 32 else 0
            windows.append(backtrack_window(hi, lo, c))
        p = 31
        for lane in range(32):
            if top - lane >= 0:
                path[top - lane] = c
            move = (windows[lane] >> p) & 1
            c -= move
            p -= move
    return path


def _walk_back(words, in_len, out_len):
    """The backtrack one row at a time, reading one bit a row."""
    path, c = [0] * out_len, in_len - 1
    for i in range(out_len - 1, 0, -1):
        path[i] = c
        c -= (words[i][c >> 5] >> (c & 31)) & 1
    path[0] = c
    return path


@pytest.mark.parametrize("L,in_len,out_len,p_move", [
    (1000, 1000, 2048, 0.5), (1000, 977, 1000, 0.97), (192, 192, 2016, 0.1),
    (33, 33, 70, 0.5), (64, 32, 31, 1.0), (1024, 1024, 33, 1.0), (40, 1, 50, 0.5),
    (160, 160, 1, 0.5),
])
def test_backtrack_windows_hold_the_bits_32_rows_need(L, in_len, out_len, p_move):
    rng = np.random.default_rng(L + out_len)
    W = (L + 31) // 32
    moves = rng.random((out_len, L)) < p_move
    moves[:, 0] = False  # column 0 never moves left
    words = [[int(sum(1 << q for q in range(32) if 32 * k + q < L and row[32 * k + q]))
              for k in range(W)] for row in moves]
    assert _chunked_backtrack(words, in_len, out_len) == _walk_back(words, in_len, out_len)


def test_backtrack_window_bit_p_is_column_c_minus_31_plus_p():
    hi, lo = 0b1011 << 3, 1 << 31  # columns 64 + 3, 64 + 4, 64 + 6 and 63
    for c in (64 + 6, 64 + 20, 64 + 31):
        window = backtrack_window(hi, lo, c)
        cols = {c - 31 + p for p in range(32) if (window >> p) & 1}
        assert cols == {col for col in (63, 67, 68, 70) if c - 31 <= col <= c}
    assert backtrack_window(0xFFFFFFFF, 0, 5) == 0b111111 << 26  # no column below 0


# the fused stages of a low-latency window of the V1 vocoder: 128 + 2 * 15
# frames, upsampled 64x to the C = 128 stage and twice more at each next one
STREAM_WINDOW_STAGES = [(128, 158 * 64), (64, 158 * 128), (32, 158 * 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T", STREAM_WINDOW_STAGES)
def test_mrf_stage_at_a_streaming_window_matches_plain_version(cuda, C, T, dtype):
    test_mrf_stage_kernel_matches_plain_version(cuda, C, dtype, 1, T)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 8, 12, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(2, 300), (1, 37), (1, 127), (1, 129), (1, 257), (1, 1000)])
def test_mrf_stage_kernel_matches_plain_version(cuda, C, dtype, B, T):
    """A stage of C <= 16 is one launch of the whole-stage kernel, a wider
    one 18 launches of the conv kernel; both within ``_mrf_tol``, on the
    whole output and on the first and last 64 rows (where SAME padding
    shows)."""
    _check_stage(cuda, C, dtype, B, T, KS, DILS)


def _check_stage(cuda, C, dtype, B, T, ks, dils, seed=1):
    blocks = _stage_blocks(C, cuda, seed=seed, ks=ks, dils=dils)
    g = torch.Generator(device=cuda).manual_seed(T)
    x = torch.randn(B, T, C, device=cuda, generator=g).to(dtype)
    flat = prepare_stage_weights(blocks, ks, dils, dtype)
    convs, stages = mrf_conv.launches, mrf_stage.launches
    out = fused_mrf_stage(x, flat, ks, dils)
    torch.cuda.synchronize()
    if mrf_route(C, ks, dils) == "stage":
        assert (mrf_conv.launches - convs, mrf_stage.launches - stages) == (0, 1)
    else:
        assert (mrf_conv.launches - convs, mrf_stage.launches - stages) == \
            (2 * sum(len(d) for d in dils), 0)
    ref_blocks = [{n: w.to(dtype).float() for n, w in p.items()} for p in blocks]
    want = mrf_stage_reference(x.float(), ref_blocks, ks, dils)
    assert out.dtype == dtype and out.shape == x.shape
    edge = min(T, 64)
    for part in (slice(None), slice(0, edge), slice(T - edge, T)):
        assert _rel(out[:, part], want[:, part]) <= _mrf_tol(dtype)


# whole-stage shapes besides V1's and V2's (all on the one-launch route):
# k 1 beside k 5 with unequal dilation counts, an even k within the halo,
# four dilations, the widest conv (k 65: the largest weight buffers), k 2
# at a span of 63
OTHER_STAGES = [((1, 5), ((1, 2), (3,))), ((4,), ((1, 3, 5),)),
                ((3, 7), ((1, 3, 5, 7), (1, 2))), ((65,), ((1,),)), ((2,), ((63,),))]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks,dils", OTHER_STAGES)
def test_mrf_stage_kernel_at_other_stage_shapes(cuda, C, dtype, ks, dils):
    assert mrf_route(C, ks, dils) == "stage"
    _check_stage(cuda, C, dtype, 2, 300, ks, dils, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_even_kernel_narrow_stage_past_the_halo_takes_the_conv_route(cuda, C, dtype):
    """k 4 at dilations 9 x 5: JAX's gate counts 50, the chain reads 80
    rows to one side, past the whole-stage kernel's 64: 10 ``mrf_conv``
    launches at C 16."""
    ks, dils = (4,), ((9, 9, 9, 9, 9),)
    assert mrf_route(C, ks, dils) == "conv"
    _check_stage(cuda, C, dtype, 2, 300, ks, dils, seed=2)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [WRITE, ACCUMULATE, FINISH])
@pytest.mark.parametrize("K,dil", [(3, 1), (7, 3), (11, 5)])
def test_mrf_conv_modes_and_edges_match_plain_version(cuda, C, dtype, mode, K, dil):
    """One conv with `residual is out`, each epilogue mode; the whole output
    and the first and last half * dilation rows (where SAME padding shows) on
    their own."""
    _check_mrf_conv(cuda, C, dtype, mode, K, dil)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [8, 16, 24, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,dil", [(7, 9), (9, 9), (3, 63), (5, 31), (4, 5), (2, 3)])
def test_mrf_conv_at_wide_spans_even_kernels_and_padded_widths(cuda, C, dtype, K, dil):
    """Spans (K - 1) * dil past 50 (the wide build, to 126), even kernel
    sizes (SAME padding: (K - 1) * dil // 2 before), and C of no build,
    whose operands ``mrf_conv`` pads to the next build's width."""
    _check_mrf_conv(cuda, C, dtype, FINISH, K, dil)


def _check_mrf_conv(cuda, C, dtype, mode, K, dil):
    B, T = 2, 300
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(B, T, C, device=cuda, generator=g).to(dtype)
    res = torch.randn(B, T, C, device=cuda, generator=g).to(dtype)
    acc0 = torch.randn(B, T, C, device=cuda, generator=g)
    w32 = torch.randn(K, C, C, device=cuda, generator=g) / math.sqrt(K * C)
    bias = (0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    width = vocoder_resblocks.conv_channels(C)
    w_k = torch.nn.functional.pad(w32, (0, width - C, 0, width - C))
    w = split_bf16(w_k) if dtype == torch.float32 else w_k.to(torch.bfloat16)
    w_ref = w32 if dtype == torch.float32 else w32.to(torch.bfloat16).float()
    bias_k = torch.nn.functional.pad(bias, (0, width - C))
    before = mrf_conv.launches
    out, acc = res.clone(), acc0.clone()
    mrf_conv(x, w, bias_k, dil, residual=out, out=out, acc=acc, mode=mode, scale=1 / 3)
    torch.cuda.synchronize()
    assert mrf_conv.launches == before + 1

    want_out, want_acc = res.float(), acc0.clone()
    mrf_conv_reference(x, w_ref, bias, dil, residual=res, out=want_out, acc=want_acc,
                       mode=mode, scale=1 / 3)
    got, want = (acc, want_acc) if mode == ACCUMULATE else (out, want_out)
    edge = max((K - 1) * dil // 2, 1)
    tol = _mrf_tol(dtype)
    assert _rel(got, want) <= tol
    assert _rel(got[:, :edge], want[:, :edge]) <= tol
    assert _rel(got[:, -edge:], want[:, -edge:]) <= tol
    if mode == ACCUMULATE:
        assert torch.equal(out, res)  # this mode writes no `out`
    else:
        assert torch.equal(acc, acc0)


@pytest.mark.gpu
def test_mrf_kernel_refuses_autograd_on_the_card(cuda):
    """On the card the stage raises under autograd before it launches."""
    blocks = _stage_blocks(64, cuda)
    x = torch.randn(1, 300, 64, device=cuda, requires_grad=True)
    flat = prepare_stage_weights(blocks, KS, DILS, torch.float32)
    before = mrf_conv.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mrf_stage(x, flat, KS, DILS)
    assert mrf_conv.launches == before
    with torch.no_grad():
        fused_mrf_stage(x, flat, KS, DILS)
    torch.cuda.synchronize()
    assert mrf_conv.launches == before + 18


@pytest.mark.gpu
def test_mrf_stage_kernel_refuses_autograd_on_the_card(cuda):
    """The whole-stage kernel, too, raises under autograd before it launches."""
    blocks = _stage_blocks(16, cuda)
    x = torch.randn(1, 300, 16, device=cuda, requires_grad=True)
    flat = prepare_stage_weights(blocks, KS, DILS, torch.float32)
    before = mrf_stage.launches
    for fn in (fused_mrf_stage, mrf_stage):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x, flat, KS, DILS)
    assert mrf_stage.launches == before
    with torch.no_grad():
        fused_mrf_stage(x, flat, KS, DILS)
    torch.cuda.synchronize()
    assert mrf_stage.launches == before + 1


@pytest.mark.gpu
def test_mrf_stage_raises_on_what_the_kernel_does_not_take(cuda):
    blocks = _stage_blocks(16, cuda)
    flat = prepare_stage_weights(blocks, KS, DILS, torch.float32)
    x = torch.zeros(1, 64, 16, device=cuda)
    mrf_stage(x, flat, KS, DILS)
    with pytest.raises(ValueError, match="C in"):
        mrf_stage(torch.zeros(1, 64, 32, device=cuda), flat, KS, DILS)
    with pytest.raises(ValueError, match="C in"):
        mrf_stage(torch.zeros(1, 32, 64, device=cuda).transpose(1, 2), flat, KS, DILS)
    with pytest.raises(ValueError, match="reach at most 64"):
        mrf_stage(x, flat, (4,), ((9, 9, 9, 9, 9),))
    with pytest.raises(ValueError, match="weights for"):
        mrf_stage(x, flat[:-4], KS, DILS)
    with pytest.raises(ValueError, match="prepare_stage_weights"):
        mrf_stage(x.bfloat16(), flat, KS, DILS)  # f32 pairs for bf16 x
    with pytest.raises(ValueError, match="not supported"):
        mrf_stage(x.half(), flat, KS, DILS)
    with pytest.raises(ValueError, match="contiguous on"):
        mrf_stage(x, [w.cpu() if i == 0 else w for i, w in enumerate(flat)], KS, DILS)


@pytest.mark.gpu
def test_mrf_conv_raises_on_what_the_kernel_does_not_take(cuda):
    def call(C=32, K=3, dil=1, dtype=torch.float32, w=None, alias=False):
        x = torch.zeros(1, 64, C, device=cuda, dtype=dtype)
        if w is None:
            w = torch.zeros((2, K, C, C) if dtype == torch.float32 else (K, C, C),
                            device=cuda, dtype=torch.bfloat16)
        bias = torch.zeros(C, device=cuda, dtype=dtype)
        mrf_conv(x, w, bias, dil, out=x if alias else torch.empty_like(x))

    call()
    call(C=16)
    call(K=4)
    call(K=11, dil=12)  # span 120: the wide build
    with pytest.raises(ValueError, match="must not alias"):
        call(alias=True)
    with pytest.raises(ValueError, match="not in"):
        call(C=48)  # weights at 48, not prepared at the build's width 64
    with pytest.raises(ValueError, match="C <= 128"):
        call(C=256)
    with pytest.raises(ValueError, match="kernel size"):
        call(K=3, dil=64)
    with pytest.raises(ValueError, match="kernel size"):
        call(K=11, dil=13)
    with pytest.raises(ValueError, match="prepare_stage_weights"):
        call(w=torch.zeros(3, 32, 32, device=cuda))  # f32 weights, not the bf16 pair
    with pytest.raises(ValueError, match="prepare_stage_weights"):
        call(dtype=torch.bfloat16, w=torch.zeros(2, 3, 32, 32, device=cuda,
                                                  dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="not supported"):
        call(dtype=torch.float16, w=torch.zeros(3, 32, 32, device=cuda, dtype=torch.bfloat16))


def _attention_inputs(cuda, B, H, T, dh, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, dh, device=cuda, generator=g).to(dtype) for _ in range(3))
    lens = torch.tensor([T, max(T - 37, 1), 5] * B, device=cuda)[:B]
    bias = torch.where(torch.arange(T, device=cuda)[None] < lens[:, None], 0.0,
                       attention.NEG_INF).float()
    do = torch.randn(B, H, T, dh, device=cuda, generator=g).to(dtype)
    return q, k, v, bias, do


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,dh", [(3, 2, 37, 64), (2, 2, 200, 128), (3, 2, 200, 192),
                                      (2, 2, 130, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_attention_dropout_kernels_match_plain_version(cuda, B, H, T, dh, dtype, p):
    q, k, v, bias, do = _attention_inputs(cuda, B, H, T, dh, dtype)
    seed = torch.tensor([1234], dtype=torch.int32, device=cuda)
    scale = 1.0 / math.sqrt(dh)
    f0, b0 = attention_fwd.launches, attention_bwd.launches
    out, lse = attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)
    grads = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (f0 + 1, b0 + 1)
    qf, kf, vf = q.float(), k.float(), v.float()
    assert _rel(out, attention_dropout_reference(qf, kf, vf, bias, seed, p, scale)) <= _tol(dtype)
    want = attention_bwd_reference(qf, kf, vf, bias, seed, p, scale, do.float())
    for got, ref in zip(grads, want):
        assert got.dtype == dtype
        assert _rel(got, ref) <= _tol(dtype)


@pytest.mark.gpu
def test_attention_with_dropout_is_an_autograd_function_over_both_kernels(cuda):
    q, k, v, bias, do = _attention_inputs(cuda, 2, 2, 70, 64, torch.float32)
    qkv = torch.stack([q, k, v], 2).transpose(1, 3).contiguous().requires_grad_(True)  # [B,T,3,H,dh]
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    out = attention_with_dropout(*views, bias, seed, 0.2, 0.125)
    (out * do).sum().backward()
    ref = qkv.detach().clone().requires_grad_(True)
    rviews = [ref[:, :, i].transpose(1, 2) for i in range(3)]
    (attention_dropout_reference(*rviews, bias, seed, 0.2, 0.125) * do).sum().backward()
    assert _rel(qkv.grad, ref.grad) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_op_passes_opcheck_on_the_card(cuda, dtype, p, with_lse):
    """``fs2t::attention_fwd`` on CUDA tensors: its schema, its fake (the
    kernel's strides), and the same output from repeated launches."""
    q, k, v, bias, _ = _attention_inputs(cuda, 2, 2, 100, 64, dtype)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda) if p > 0 else None
    before = attention_fwd.launches
    torch.library.opcheck(torch.ops.fs2t.attention_fwd.default,
                          (q, k, v, bias, 0.125, p, seed, with_lse))
    assert attention_fwd.launches > before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_conformer_block_launches_kernel_a(cuda, dtype):
    """A one-layer Conformer exported on the card, saved, loaded and run:
    its graph calls the op, each run of the loaded program launches kernel A
    once, and its output equals the eager block's (f32 within max-abs 1e-6,
    bf16 within rel-L2 1e-3: the same kernels on the same inputs)."""
    import io

    from fastspeech2_lightning_tpu_torch.models.conformer import Conformer

    torch.manual_seed(0)
    block = Conformer(128, 1, 2, 256, 7, dtype=dtype).to(cuda).eval()
    x = torch.randn(2, 300, 128, device=cuda)
    mask = torch.arange(300, device=cuda)[None] < torch.tensor([[300], [171]], device=cuda)
    with torch.no_grad():
        ep = torch.export.export(block, (x, mask))
    assert [str(n.target) for n in ep.graph.nodes
            if "attention" in str(n.target)] == ["fs2t.attention_fwd.default"]
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    with torch.inference_mode():
        want = block(x, mask)
        before = attention_fwd.launches
        got = loaded(x, mask)
        got = loaded(x, mask)
        torch.cuda.synchronize()
    assert attention_fwd.launches == before + 2
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6
    else:
        assert _rel(got, want.float()) <= 1e-3


def _poisoned_outputs(monkeypatch):
    """Make every buffer the wrapper allocates with torch.empty start as NaN
    (floats) or -1 (ints), so an output the C entry did not zero on the
    stream would show."""
    real_empty = torch.empty

    def poisoned(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t.fill_(-1)

    monkeypatch.setattr(torch, "empty", poisoned)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,L", [(4, 300, 40), (3, 160, 1000), (2, 2048, 160),
                                   (16, 2016, 192), (3, 100, 1024), (4, 70, 33), (3, 200, 300),
                                   (2, 100, 512), (2, 100, 256), (2, 100, 257),
                                   (3, 1100, 1025), (2, 2100, 2048), (2, 2100, 2049),
                                   (2, 600, 4100), (1, 8192, 8191), (1, 300, 8192),
                                   (1, 1100, 1025), (16, 600, 2000), (4, 40, 3073)])
def test_mas_kernel_equals_plain_version(cuda, monkeypatch, B, T, L):
    g = torch.Generator(device=cuda).manual_seed(2)
    la = torch.log_softmax(torch.randn(B, T, L, device=cuda, generator=g), -1)
    la[0, :, 1::3] = la[0, :, :1]  # exact ties between neighbours
    in_lens = torch.tensor(([L, max(L // 2, 1), 7, 1] * B)[:B], device=cuda)
    out_lens = torch.tensor(([T, T - 13, max(T // 3, 7), 5] * B)[:B], device=cuda)
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    _poisoned_outputs(monkeypatch)
    before = mas_width1.launches
    hard, dur = mas_width1(la, in_lens, out_lens)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert mas_width1.launches == before + 1
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)
    assert torch.equal(dur.sum(1).cpu(), out_lens.int().cpu())


@pytest.mark.gpu
def test_mas_kernel_on_length_edges(cuda, monkeypatch):
    """in_len = 1, out_len = 1, out_len = T, in_len = L, a path that moves
    left at every row, and lengths outside [1, L] (or no frame), which leave
    the item zero."""
    T, L = 90, 70
    g = torch.Generator(device=cuda).manual_seed(4)
    in_lens = torch.tensor([1, L, 40, L, 33, 0, L + 1, 20, -3, 64], device=cuda)
    out_lens = torch.tensor([T, 1, T, T, 33, T, T, 0, 5, T + 7], device=cuda)
    B = len(in_lens)
    la = torch.log_softmax(torch.randn(B, T, L, device=cuda, generator=g), -1)
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    _poisoned_outputs(monkeypatch)
    hard, dur = mas_width1(la, in_lens, out_lens)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)
    for b in (5, 6, 7, 8):
        assert not hard[b].any() and not dur[b].any()
    assert dur[4].tolist()[:33] == [1] * 33  # in_len = out_len: one frame a symbol
    assert int(dur[0, 0]) == T and int(dur[1, L - 1]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2049, 3000])
def test_mas_kernel_at_slice_boundaries(cuda, monkeypatch, L):
    """The cluster kernel with in_len inside the first slice, on a slice
    boundary and one past it (the next block with nothing to do, or one
    live column), and lengths outside [1, L], which leave the item zero."""
    T = 1100
    in_lens = torch.tensor([500, 1024, 1025, 2048, 2049, 1, L, 0, L + 1], device=cuda)
    out_lens = torch.tensor([T, 1050, T, T - 1, 1100, 1, 900, T, T], device=cuda)
    B = len(in_lens)
    g = torch.Generator(device=cuda).manual_seed(6)
    la = torch.log_softmax(torch.randn(B, T, L, device=cuda, generator=g), -1)
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    _poisoned_outputs(monkeypatch)
    hard, dur = mas_width1(la, in_lens, out_lens)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)
    assert not hard[-2:].any() and not dur[-2:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("T,L", [(300, 8193), (1100, 12000), (700, 16385)])
def test_mas_kernel_in_panels(cuda, monkeypatch, T, L):
    """Past PANEL_L columns the clusters run in panels launched in turn, the
    halo across a panel boundary through device memory: one launch counted,
    and bit for bit the plain version's with in_len inside the first panel,
    on a panel boundary and one past it, at L, on the edges of a slice of
    the next panel, and lengths outside [1, L]."""
    P = mas.PANEL_L
    in_lens = torch.tensor([P // 2, P, P + 1, L, L - 1, P + 1024, 2 * P, 0, L + 1],
                           device=cuda).clamp(max=L + 1)
    out_lens = torch.tensor([T, T - 1, T, T, 17, T - 15, T, T, T], device=cuda)
    B = len(in_lens)
    g = torch.Generator(device=cuda).manual_seed(L)
    la = torch.log_softmax(torch.randn(B, T, L, device=cuda, generator=g), -1)
    la[0, :, 1::3] = la[0, :, :1]  # exact ties between neighbours
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    _poisoned_outputs(monkeypatch)
    before = mas_width1.launches
    hard, dur = mas_width1(la, in_lens, out_lens)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert mas_width1.launches == before + 1
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)
    assert not hard[-2:].any() and not dur[-2:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("L", [64, 1000, 2048])
def test_mas_kernel_takes_a_log_attention_off_16_bytes(cuda, L):
    """A contiguous view starting 4 bytes past a 16-byte boundary: the copy
    warps stage it four bytes a copy instead of 16."""
    B, T = 2, 300
    g = torch.Generator(device=cuda).manual_seed(8)
    flat = torch.log_softmax(torch.randn(B * T * L + 1, device=cuda, generator=g), -1)
    la = flat[1:].view(B, T, L)
    assert la.data_ptr() % 16 == 4 and la.is_contiguous()
    in_lens = torch.tensor([L, L - 3], device=cuda)
    out_lens = torch.tensor([T, T - 7], device=cuda)
    hard, dur = mas_width1(la, in_lens, out_lens)
    torch.cuda.synchronize()
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 1024, 1025, 2000, 4096, 8192, 8193, 16385, 30000])
def test_mas_cluster_layout_follows_the_python_constants(cuda, L):
    """The layout the C entry reports: one block up to RING_L, past it
    ceil(L / SLICE_L) blocks of SLICE_L columns, eight at most a cluster,
    in ceil(L / PANEL_L) panels, taking EDGE_COLUMNS from the left every
    MEET_ROWS rows, of which the card holds a cluster at least."""
    got = mas.cluster_layout(L)
    assert got["panels"] == -(-L // mas.PANEL_L)
    if L <= mas.RING_L:
        assert got["blocks"] == 1 and got["max_active_clusters"] == 0
        return
    assert got["blocks"] == min(-(-L // mas.SLICE_L), mas.PANEL_L // mas.SLICE_L)
    assert (got["slice"], got["edge"], got["meet"]) == (mas.SLICE_L, mas.EDGE_COLUMNS,
                                                       mas.MEET_ROWS)
    assert got["max_active_clusters"] >= 1


def _ctc_inputs(dev, B, T, L, seed=3):
    """Log-probabilities [B, T, L+1] over random logits with the columns past
    in_len at NEG_INF, and lengths with the edge items first: in_len = L and
    out_len = T, in_len = 1 over all frames, in_len = out_len = 1, in_len = L
    over L - 1 frames (infeasible for L > 1), then lengths drawn from [1, L]
    and [1, T]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    in_lens = torch.randint(1, L + 1, (B,), device=dev, generator=g)
    out_lens = torch.randint(1, T + 1, (B,), device=dev, generator=g)
    edges = [(L, T), (1, T), (1, 1), (L, max(1, min(L - 1, T)))]
    for b, (n_in, n_out) in enumerate(edges[:B]):
        in_lens[b], out_lens[b] = n_in, n_out
    logits = torch.randn(B, T, L + 1, device=dev, generator=g)
    logits = torch.where(torch.arange(L + 1, device=dev) > in_lens[:, None, None],
                         ctc.NEG_INF, logits)
    return torch.log_softmax(logits, -1), in_lens, out_lens


def _rows_agree(got, want):
    """The same states on the NEG_INF scale and the others within relative
    1e-5 (the kernel repeats the plain version's arithmetic)."""
    live = want > 0.5 * ctc.NEG_INF
    assert torch.equal(got > 0.5 * ctc.NEG_INF, live)
    assert torch.allclose(got[live], want[live], rtol=1e-5, atol=0)


def test_ctc_wrappers_run_their_plain_versions_on_the_cpu():
    """On CPU tensors each CTC wrapper is its plain version and counts no
    launch; the chains' rows give the gradient of the loss."""
    lp, in_lens, out_lens = _ctc_inputs("cpu", 4, 30, 6)
    gvec = torch.rand(4, generator=torch.Generator().manual_seed(1))
    counts = (ctc_alpha.launches, ctc_alpha_beta.launches, ctc_grad.launches)
    alphas, betas = ctc_alpha_beta(lp, in_lens, out_lens)
    assert torch.equal(alphas, ctc_alpha_reference(lp, out_lens))
    assert torch.equal(ctc_alpha(lp, out_lens), alphas)
    assert torch.equal(betas, ctc_beta_reference(lp, in_lens, out_lens))
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    grad = ctc_grad(alphas, betas, out_lens, ll, gvec)
    assert torch.equal(grad, ctc_grad_reference(alphas, betas, out_lens, ll, gvec))
    assert counts == (ctc_alpha.launches, ctc_alpha_beta.launches, ctc_grad.launches)
    x = lp.clone().requires_grad_(True)
    (ctc_forward_sum(x, in_lens, out_lens) * gvec).sum().backward()
    assert torch.equal(x.grad, grad)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,L", [(3, 120, 20), (2, 300, 160), (16, 2016, 192), (16, 512, 64),
                                   (4, 64, 1023), (4, 50, 1), (5, 9, 300),
                                   (4, 1100, 1024), (4, 2100, 2048), (2, 300, 2687),
                                   (2, 300, 2688), (2, 8192, 8191), (1, 700, 8191),
                                   (1, 600, 1024), (16, 300, 2000), (2, 600, 2000),
                                   (3, 50, 1100), (16, 100, 8191)])
def test_ctc_kernels_match_plain_version(cuda, monkeypatch, B, T, L):
    """Both chains and the gradient against the plain version, every output
    written (NaN before the call), edge and infeasible items included; an
    infeasible item (fewer frames than labels) gets g = 0, as the loss gives
    it, and so a zero gradient."""
    lp, in_lens, out_lens = _ctc_inputs(cuda, B, T, L)
    feasible = out_lens.clamp(max=T) >= in_lens
    gvec = torch.rand(B, device=cuda, generator=torch.Generator(device=cuda).manual_seed(5))
    gvec = torch.where(feasible, gvec, 0.0)
    want_alphas = ctc_alpha_reference(lp, out_lens)
    want_betas = ctc_beta_reference(lp, in_lens, out_lens)
    want_ll = ctc._final_ll(want_alphas[:, -1], in_lens)
    want_grad = ctc_grad_reference(want_alphas, want_betas, out_lens, want_ll, gvec)
    _poisoned_outputs(monkeypatch)
    a0, ab0, g0 = ctc_alpha.launches, ctc_alpha_beta.launches, ctc_grad.launches
    alphas_only = ctc_alpha(lp, out_lens)
    alphas, betas = ctc_alpha_beta(lp, in_lens, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    grad = ctc_grad(alphas, betas, out_lens, ll, gvec)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert (ctc_alpha.launches, ctc_alpha_beta.launches, ctc_grad.launches) == (
        a0 + 1, ab0 + 1, g0 + 1)
    for t in (alphas_only, alphas, betas, grad):
        assert not t.isnan().any()
    assert torch.equal(alphas_only, alphas)
    _rows_agree(alphas, want_alphas)
    _rows_agree(betas, want_betas)
    assert float(((ll - want_ll).abs() / want_ll.abs()).max()) <= 1e-5
    assert float((grad - want_grad).abs().max()) <= 1e-5
    assert bool(torch.isfinite(grad).all()) and not grad[~feasible].any()
    assert not grad[torch.arange(T, device=cuda)[None] >= out_lens[:, None]].any()
    if B >= 4 and L > 1:
        assert float(ll[3]) < 1e-3 * ctc.NEG_INF  # infeasible: ll on the NEG_INF scale


def _feasible_ctc_inputs(dev, T, L, lens, seed=7):
    """Log-probabilities [B, T, L+1] over random logits, the columns past
    in_len at NEG_INF, for the (in_len, out_len) pairs `lens`."""
    in_lens = torch.tensor([a for a, _ in lens], device=dev)
    out_lens = torch.tensor([b for _, b in lens], device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(len(lens), T, L + 1, device=dev, generator=g)
    logits = torch.where(torch.arange(L + 1, device=dev) > in_lens[:, None, None],
                         ctc.NEG_INF, logits)
    return torch.log_softmax(logits, -1), in_lens, out_lens


CTC_PANELS = {
    "S_16385_edges": (300, 8192, None),
    "S_16387": (8300, 8193, [(8193, 8300), (8100, 8250)]),
    "S_24001": (12100, 12000, [(12000, 12100), (8192, 12000), (8191, 9000)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CTC_PANELS))
def test_ctc_kernels_in_panels(cuda, monkeypatch, case):
    """Past PANEL_S states a chain runs in panels launched in turn, each
    panel's first block taking its halo from the rows the panel before it
    stored: one launch of each entry counted, every row written, both
    chains' rows and the loss bit for bit the plain version's and the
    gradient within max-abs 1e-5 of it, on the edge items of
    ``_ctc_inputs`` and on items whose texts end in either panel."""
    T, L, lens = CTC_PANELS[case]
    if lens is None:
        lp, in_lens, out_lens = _ctc_inputs(cuda, 2, T, L)
    else:
        lp, in_lens, out_lens = _feasible_ctc_inputs(cuda, T, L, lens)
    assert ctc.cluster_layout(2 * len(in_lens), L)["panels"] >= 2
    g = torch.Generator(device=cuda).manual_seed(5)
    gvec = torch.rand(len(in_lens), device=cuda, generator=g)
    want_alphas = ctc_alpha_reference(lp, out_lens)
    want_betas = ctc_beta_reference(lp, in_lens, out_lens)
    want_ll = ctc._final_ll(want_alphas[:, -1], in_lens)
    _poisoned_outputs(monkeypatch)
    a0, ab0, g0 = ctc_alpha.launches, ctc_alpha_beta.launches, ctc_grad.launches
    alphas_only = ctc_alpha(lp, out_lens)
    alphas, betas = ctc_alpha_beta(lp, in_lens, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    grad = ctc_grad(alphas, betas, out_lens, ll, gvec)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert (ctc_alpha.launches, ctc_alpha_beta.launches, ctc_grad.launches) == (
        a0 + 1, ab0 + 1, g0 + 1)
    for t in (alphas_only, alphas, betas, grad):
        assert not t.isnan().any()
    assert torch.equal(alphas_only, want_alphas) and torch.equal(alphas, want_alphas)
    assert torch.equal(betas, want_betas) and torch.equal(ll, want_ll)
    want_grad = ctc_grad_reference(want_alphas, want_betas, out_lens, want_ll, gvec)
    assert float((grad - want_grad).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("chains,L", [(1, 1023), (1, 1024), (4, 1100), (16, 2000), (32, 2000),
                                      (32, 2048), (1, 8191), (16, 8191), (32, 8191), (2, 500),
                                      (2, 8192), (4, 12000), (1, 20000)])
def test_ctc_cluster_layout_follows_the_python_constants(cuda, chains, L):
    """The limits the C entries keep to are ops/ctc.py's (RING_S,
    MAX_CLUSTER, SLICE_WARPS, PANEL_S), and the layout they report: one
    block a chain up to RING_S; past it at most MAX_CLUSTER blocks of at
    most SLICE_WARPS warps of WARP_STATES states that hold S between them
    (a panel's share of it past PANEL_S: ceil(S / PANEL_S) panels or one
    more, of equal layout), taking HALO_STATES from the left every
    MEET_FRAMES frames; one chain in the narrowest slices MAX_CLUSTER blocks
    allow (it takes one wave at any size); the chains' clusters all on the
    card at once where the fewest blocks that hold S take at most 64 SMs in
    all."""
    limits = (ctypes.c_int * 4)()
    lib = build.load("ctc_banded_lse", ctc._SIGNATURES)
    assert lib.ctc_cluster_limits(limits) == 0
    assert tuple(limits) == (ctc.RING_S, ctc.MAX_CLUSTER, ctc.SLICE_WARPS, ctc.PANEL_S)
    S = 2 * L + 1
    got = ctc.cluster_layout(chains, L)
    if S <= ctc.RING_S:
        assert got["blocks"] == 1 and got["max_active_clusters"] == 0 and got["panels"] == 1
        return
    first = -(-S // ctc.PANEL_S)
    assert got["panels"] in (first, first + 1)
    assert got["panels"] * got["blocks"] * got["states"] >= S
    assert (got["panels"] - 1) * got["blocks"] * got["states"] < S
    if got["panels"] > 1:
        assert got["max_active_clusters"] >= 1
        return
    if chains == 1:
        warps = -(-(-(-S // ctc.MAX_CLUSTER)) // ctc.WARP_STATES)
        assert (got["warps"], got["blocks"]) == (warps, -(-S // (warps * ctc.WARP_STATES)))
    assert (got["halo"], got["meet"]) == (ctc.HALO_STATES, ctc.MEET_FRAMES)
    assert got["states"] == got["warps"] * ctc.WARP_STATES
    assert 1 <= got["warps"] <= ctc.SLICE_WARPS and 1 <= got["blocks"] <= ctc.MAX_CLUSTER
    assert got["blocks"] * got["states"] >= S > (got["blocks"] - 1) * got["states"]
    assert got["max_active_clusters"] >= 1
    if chains * -(-S // (ctc.SLICE_WARPS * ctc.WARP_STATES)) <= 64:
        assert got["max_active_clusters"] >= chains


@pytest.mark.gpu
def test_kernels_refuse_another_cluster_layout(cuda, monkeypatch):
    """The layout constants cross to the C entries, which refuse any other
    than they were built for: a Python constant that drifted raises."""
    la = torch.log_softmax(torch.randn(1, 8, 1100, device=cuda), -1)
    lens = torch.tensor([1100], device=cuda)
    lp, in_lens, out_lens = _ctc_inputs(cuda, 1, 8, 1100)
    monkeypatch.setattr(mas, "SLICE_L", 512)
    with pytest.raises(RuntimeError, match="mas_width1"):
        mas_width1(la, lens, lens)
    monkeypatch.undo()
    monkeypatch.setattr(mas, "PANEL_L", 4096)
    with pytest.raises(RuntimeError, match="mas_width1"):
        mas_width1(la, lens, lens)
    for drifted in ((ctc.WARP_STATES, ctc.HALO_STATES, 2 * ctc.MEET_FRAMES, ctc.PANEL_S),
                    (ctc.WARP_STATES, ctc.HALO_STATES, ctc.MEET_FRAMES, 2 * ctc.PANEL_S)):
        monkeypatch.setattr(ctc, "_LAYOUT", drifted)
        with pytest.raises(RuntimeError, match="ctc_alpha"):
            ctc_alpha(lp, out_lens)
        with pytest.raises(RuntimeError, match="ctc_alpha_beta"):
            ctc_alpha_beta(lp, in_lens, out_lens)


@pytest.mark.gpu
def test_ctc_forward_sum_runs_the_beta_chain_only_for_a_gradient(cuda):
    """Under no_grad the loss launches the alpha chain alone; with a gradient
    one launch runs both chains and the backward one gradient pass. Both give
    the same loss."""
    lp, in_lens, out_lens = _ctc_inputs(cuda, 4, 200, 30)
    x = lp.clone().requires_grad_(True)
    counts = lambda: (ctc_alpha.launches, ctc_alpha_beta.launches, ctc_grad.launches)  # noqa: E731
    c0 = counts()
    with torch.no_grad():
        loss_ng = ctc_forward_sum(x, in_lens, out_lens)
    c1 = counts()
    loss = ctc_forward_sum(x, in_lens, out_lens)
    c2 = counts()
    loss.sum().backward()
    c3 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1, 0, 0)
    assert (c2[0] - c1[0], c2[1] - c1[1], c2[2] - c1[2]) == (0, 1, 0)
    assert (c3[0] - c2[0], c3[1] - c2[1], c3[2] - c2[2]) == (0, 0, 1)
    assert torch.equal(loss_ng, loss.detach())
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.gpu
def test_wrappers_raise_on_shapes_their_kernels_do_not_take(cuda):
    """dh 320, L 1025 and S 2051, past the kernels' earlier reach, and texts
    past 8192 symbols (MAS) and 8191 (CTC, S 16387), past the reach of one
    cluster, compute and agree with the plain versions; what is left to
    refuse is lengths that are not [B] and rows that are not [B, T, 2L+1]."""
    q = torch.randn(1, 2, 16, 320, device=cuda)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    bias = torch.zeros(1, 16, device=cuda)
    out = attention_fwd(q, q, q, bias, 0.125, p=0.1, seed=seed)
    assert _rel(out, attention_dropout_reference(q, q, q, bias, seed, 0.1, 0.125)) <= 1e-5
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    la = torch.log_softmax(torch.randn(1, 4, 1025, device=cuda), -1)
    assert all(torch.equal(a, b) for a, b in
               zip(mas_width1(la, lens, lens), mas_width1_reference(la, lens, lens)))
    lp, in_lens, out_lens = _ctc_inputs(cuda, 1, 8, 1025)
    _rows_agree(ctc_alpha(lp, out_lens), ctc_alpha_reference(lp, out_lens))
    la = torch.log_softmax(torch.randn(1, 4, 8193, device=cuda), -1)
    assert all(torch.equal(a, b) for a, b in
               zip(mas_width1(la, lens, lens), mas_width1_reference(la, lens, lens)))
    lp, in_lens, out_lens = _ctc_inputs(cuda, 1, 8, 8193)
    assert torch.equal(ctc_alpha(lp, out_lens), ctc_alpha_reference(lp, out_lens))
    with pytest.raises(ValueError, match="must be \\[B\\]"):
        mas_width1(la, lens[None], lens)
    alphas = ctc_alpha(lp, out_lens)
    with pytest.raises(ValueError, match="both be"):
        ctc_grad(alphas, alphas[:, :, 1:], out_lens, out_lens.float(), out_lens.float())


THREAD_DEVICES = {"one_card": ("cuda:0", "cuda:0"), "two_cards": ("cuda:0", "cuda:1")}


@pytest.mark.gpu
@pytest.mark.parametrize("where", list(THREAD_DEVICES))
def test_kernels_launched_from_two_threads_at_once(cuda, where):
    """Kernel A and the MRF stage launched from two threads at once, each on
    its own stream (as data-parallel replicas run): every output equals the
    plain version and the counters count every launch. On two cards the
    second thread's device is not the current one of the thread that built
    its inputs, so each launch must make its tensors' device current and
    the shared-memory opt-in must be set on that card too."""
    import concurrent.futures
    import threading

    devices = [torch.device(d) for d in THREAD_DEVICES[where]]
    if max(d.index for d in devices) >= torch.cuda.device_count():
        pytest.skip(f"needs {max(d.index for d in devices) + 1} cards")
    iters, B, H, T, dh, C = 20, 4, 2, 300, 128, 64
    inputs = []
    for i, dev in enumerate(devices):
        g = torch.Generator(device=dev).manual_seed(i)
        q, k, v = (torch.randn(B, H, T, dh, device=dev, generator=g).to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.where(torch.arange(T, device=dev)[None] < T - 40 * i, 0.0,
                           attention.NEG_INF).float().expand(B, T).contiguous()
        x = torch.randn(2, 600, C, device=dev, generator=g)
        flat = prepare_stage_weights(_stage_blocks(C, dev, seed=i + 1), KS, DILS, torch.float32)
        inputs.append((dev, q, k, v, bias, x, flat))
    torch.cuda.synchronize()
    start = threading.Barrier(len(devices))

    def replica(i):
        dev, q, k, v, bias, x, flat = inputs[i]
        stream = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream), torch.no_grad():
            start.wait()
            for _ in range(iters):
                o = attention_fwd(q, k, v, bias, 1.0 / math.sqrt(dh))
                y = fused_mrf_stage(x, flat, KS, DILS)
            stream.synchronize()
        return o, y

    a0, m0 = attention_fwd.launches, mrf_conv.launches
    with torch.cuda.device(devices[0]):
        with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
            outs = list(pool.map(replica, range(len(devices))))
    assert attention_fwd.launches - a0 == len(devices) * iters
    assert mrf_conv.launches - m0 == len(devices) * iters * 18
    for (dev, q, k, v, bias, x, flat), (o, y), seed in zip(inputs, outs, range(1, 3)):
        assert o.device == dev and y.device == dev
        want = attention_reference(q.float(), k.float(), v.float(), bias, 1.0 / math.sqrt(dh))
        assert _rel(o, want) <= _tol(torch.bfloat16)
        blocks = _stage_blocks(C, dev, seed=seed)
        assert _rel(y, mrf_stage_reference(x, blocks, KS, DILS)) <= _mrf_tol(torch.float32)


def _replayed(graph, counts, n: int = 1) -> None:
    """Replay `graph` n times, adding its capture's launches each time, as
    ``TrainStepGraph`` does."""
    for _ in range(n):
        graph.replay()
        build.add(counts)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_attention_kernels_under_capture_equal_their_eager_launches(cuda):
    """A (p 0.2) and A' captured in one CUDA graph through the autograd
    Function; each replay reads a new seed from the static seed tensor and
    equals an eager launch with that seed (A bit for bit; A' sums dQ with
    atomics) and the plain version; launches counted at replay only."""
    _check_capture(cuda, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [192, 96, 384, 256, 160, 512, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_under_capture_at_wide_and_padded_head_dims(cuda, dh, dtype):
    """As the dh 128 capture, at dh 192 and 256 (built; in bf16 A's two
    warpgroups on shared K and V tiles, its TMA maps encoded at capture,
    and 64 keys a backward block split between the warpgroups), 96 and 160
    (padded to 128 and 192: the padding copies are captured too), 384, 512
    and 768 (A in one group, each score once, in bf16; A′'s two groups of
    192 at 384, of 256 at 512, three at 768)."""
    _check_capture(cuda, dh, dtype)


def _check_capture(cuda, dh, dtype=torch.float32):
    q, k, v, bias, do = _attention_inputs(cuda, 2, 2, 200, dh, dtype)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda)
    static = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def run(qkv, s):
        out = attention_with_dropout(*qkv, bias, s, 0.2, 0.125)
        return (out,) + torch.autograd.grad(out, qkv, do)

    run(static, seed)  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    f0, b0 = attention_fwd.launches, attention_bwd.launches
    with build.recording() as counts:
        with torch.cuda.graph(graph):
            outs = run(static, seed)
    assert (attention_fwd.launches, attention_bwd.launches) == (f0, b0)
    assert counts == {(attention_fwd, "launches"): 1, (attention_bwd, "launches"): 1,
                      (attention_bwd, "flops"): attention.attention_bwd_flops(2, 2, 200, dh)}
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    for s in (12345, -7):
        seed.fill_(s)
        _replayed(graph, counts)
        eager = run([t.detach().requires_grad_(True) for t in (q, k, v)], seed)
        assert torch.equal(outs[0], eager[0])
        if dtype == torch.float32:
            for got, want in zip(outs[1:], eager[1:]):
                assert _rel(got, want) <= 1e-6
        else:  # dK and dV are summed in a fixed order, dQ by atomics
            _assert_dq_launches_agree(outs[1], eager[1], q, k, v, bias, seed, 0.2, 0.125, do)
            assert torch.equal(outs[2], eager[2]) and torch.equal(outs[3], eager[3])
        ref = attention_bwd_reference(qf, kf, vf, bias, seed, 0.2, 0.125, dof)
        assert _rel(outs[0], attention_dropout_reference(qf, kf, vf, bias, seed, 0.2,
                                                         0.125)) <= _tol(dtype)
        for got, want in zip(outs[1:], ref):
            assert _rel(got, want) <= _tol(dtype)
    assert (attention_fwd.launches, attention_bwd.launches) == (f0 + 4, b0 + 4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,L", [(4, 300, 40), (2, 2100, 2048)])
def test_mas_and_ctc_under_capture_equal_their_eager_launches(cuda, B, T, L):
    """B, and C's ctc_alpha_beta + ctc_grad (through the loss's autograd
    Function), each alone in a CUDA graph, replayed on new inputs copied
    into the static ones: B bit for bit, C equal to an eager launch and
    within the plain version's limits; at a default shape (the ring
    kernels) and past the rings' reach (the cluster kernels)."""
    lp, in_lens, out_lens = _ctc_inputs(cuda, B, T, L)
    la = torch.log_softmax(torch.randn(B, T, L, device=cuda), -1)
    static_la, static_lp = la.clone(), lp.clone().requires_grad_(True)

    def ctc_run(x):
        loss = ctc_forward_sum(x, in_lens, out_lens)
        return (loss,) + torch.autograd.grad(loss.sum(), x)

    mas_width1(static_la, in_lens, out_lens)
    ctc_run(static_lp)
    torch.cuda.synchronize()
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with build.recording() as mas_counts:
        with torch.cuda.graph(graphs[0]):
            hard, durations = mas_width1(static_la, in_lens, out_lens)
    with build.recording() as ctc_counts:
        with torch.cuda.graph(graphs[1]):
            loss, grad = ctc_run(static_lp)
    assert mas_counts == {(mas_width1, "launches"): 1}
    assert ctc_counts == {(ctc_alpha_beta, "launches"): 1, (ctc_grad, "launches"): 1}
    m0, ab0, g0 = mas_width1.launches, ctc_alpha_beta.launches, ctc_grad.launches
    for seed in (1, 2):
        new_lp = _ctc_inputs(cuda, B, T, L, seed=seed + 10)[0]
        new_la = torch.log_softmax(torch.randn(B, T, L, device=cuda), -1)
        static_la.copy_(new_la)
        with torch.no_grad():
            static_lp.copy_(new_lp)
        _replayed(graphs[0], mas_counts)
        _replayed(graphs[1], ctc_counts)
        want_hard, want_dur = mas_width1(new_la, in_lens, out_lens)
        assert torch.equal(hard, want_hard) and torch.equal(durations, want_dur)
        assert torch.equal(hard, mas_width1_reference(new_la, in_lens, out_lens)[0])
        eager = ctc_run(new_lp.clone().requires_grad_(True))
        assert torch.equal(loss, eager[0]) and torch.equal(grad, eager[1])
    assert (mas_width1.launches - m0, ctc_alpha_beta.launches - ab0,
            ctc_grad.launches - g0) == (4, 4, 4)  # two replays and two eager calls each


def _tiny_training(cuda, seed: int = 0):
    """A 1 + 1 layer f32 FastSpeech2 (d 128, two heads of 64, PostNet and
    every dropout on) on `cuda` with flax's initial distributions, its
    optimizer and EMA, and 4 ragged batches of one shape stacked [4, ...]."""
    from fastspeech2_lightning_tpu_torch.config import FastSpeech2Config
    from fastspeech2_lightning_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_lightning_tpu_torch.training.state import init_like_flax, make_optimizer

    layers = {"layers": 1, "heads": 2, "input_dim": 128, "feedforward_dim": 256,
              "conv_kernel_size": 3, "dropout": 0.1}
    vp = {"input_dim": 128, "n_layers": 2, "n_bins": 16}
    cfg = FastSpeech2Config.from_dict({
        "model": {"encoder": layers, "decoder": layers, "dtype": "float32",
                  "variance_predictors": {"energy": vp, "pitch": vp, "duration": vp},
                  "max_mel_length": 96},
        "preprocessing": {"audio": {"n_mels": 20}},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}},
        "training": {"batch_size": 3, "ema_decay": 0.99,
                     "optimizer": {"warmup_steps": 4}}})
    model = FastSpeech2(cfg, n_symbols=30)
    init_like_flax(model, seed)
    with torch.no_grad():
        for kind in ("pitch", "energy"):
            getattr(model.variance_adaptor, f"{kind}_bins").copy_(torch.linspace(-2, 2, 15))
    model = model.to(cuda).train()
    opt = make_optimizer(model, cfg.training)
    ema = [p.detach().clone() for p in opt.params]
    rng = np.random.default_rng(seed)
    B, L, T = 3, 12, 80
    steps = []
    for _ in range(4):
        src = rng.integers(L // 2, L + 1, B).astype(np.int32)
        mel_lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
        src[0], mel_lens[0] = L, T
        text = np.zeros((B, L), np.int32)
        prior = np.zeros((B, T, L), np.float32)
        for b in range(B):
            text[b, :src[b]] = rng.integers(1, 30, src[b])
            centre = np.arange(mel_lens[b])[:, None] / max(mel_lens[b] - 1, 1) * (src[b] - 1)
            p = np.exp(-((np.arange(src[b])[None] - centre) ** 2) / (2 * (src[b] / 6 + 1) ** 2))
            prior[b, :mel_lens[b], :src[b]] = p / p.sum(1, keepdims=True)
        frames = np.arange(T)[None] < mel_lens[:, None]
        steps.append({
            "text": text, "src_lens": src, "mel_lens": mel_lens, "attn_prior": prior,
            "mel": (rng.standard_normal((B, T, 20)) * frames[..., None]).astype(np.float32),
            "pitch": (rng.standard_normal((B, T)) * frames).astype(np.float32),
            "energy": (np.abs(rng.standard_normal((B, T))) * frames).astype(np.float32),
            "speaker_id": np.zeros(B, np.int32), "language_id": np.zeros(B, np.int32),
            "sample_weight": np.array([1.0, 1.0, 0.0], np.float32)})
    batches = {k: torch.from_numpy(np.stack([s[k] for s in steps])).to(cuda) for k in steps[0]}
    return cfg, model, opt, ema, batches


@pytest.mark.gpu
def test_captured_train_step_equals_the_eager_step(cuda, monkeypatch):
    """A tiny f32 train step captured by ``TrainStepGraph`` against the
    eager ``train_step`` from the same weights on the same 4 batches, two
    calls of 2 (step 1 the eager warm-up, steps 2 to 4 replays): the same
    attention seeds drawn inside the graph, bit for bit; losses within 1e-4
    relative at steps 1 and 2 and 1e-3 after (the JAX multi-step test's
    escalation); at step 2, the first replay from the eager run's state,
    the gradient (read off the first moments) as one vector within rel-L2
    1e-4 and the update and the EMA's within 1e-3 on the elements whose
    moments agree (``_step_two_errors``); the update count on the device and
    the host; and the kernels' launch counters counting every replay."""
    from fastspeech2_lightning_tpu_torch.models import conformer
    from fastspeech2_lightning_tpu_torch.training.step import TrainStepGraph, train_step

    seeds = []
    real = conformer.attention_with_dropout

    def recorded(q, k, v, bias, seed, *args, **kwargs):
        seeds.append(seed)
        return real(q, k, v, bias, seed, *args, **kwargs)

    monkeypatch.setattr(conformer, "attention_with_dropout", recorded)
    fns = (attention_fwd, attention_bwd, mas_width1, ctc_alpha_beta, ctc_grad)

    def launches():
        return [fn.launches for fn in fns]

    cfg, model, opt, ema, batches = _tiny_training(cuda)
    start = launches()
    eager_rows, eager_seeds, eager_states = [], [], []
    for i in range(4):
        seeds.clear()
        losses = train_step(model, opt, cfg, {k: v[i] for k, v in batches.items()}, i, 0, ema)
        eager_rows.append({k: float(v) for k, v in losses.items()})
        eager_seeds.append([int(s) for s in seeds])
        eager_states.append(_train_state(model, opt, ema))
    per_step = [(n - s) / 4 for n, s in zip(launches(), start)]
    assert per_step == [2, 2, 1, 1, 1]
    assert len(set(map(tuple, eager_seeds))) == 4

    cfg, model, opt, ema, batches = _tiny_training(cuda)
    graph = TrainStepGraph(model, opt, cfg, ema)
    start = launches()
    seeds.clear()
    names, rows = graph.run({k: v[:2] for k, v in batches.items()}, 0, 0)
    rows = rows.cpu().tolist()
    assert [int(s) for s in seeds[:2]] == eager_seeds[0]  # the warm-up's
    captured = seeds[2:4]  # the graph's seed tensors, rewritten by each replay
    assert [int(s) for s in captured] == eager_seeds[1]
    assert len(graph.graphs) == 1 and len(graph.capture_ms) == 1
    second = _train_state(model, opt, ema)
    names, rows2 = graph.run({k: v[2:] for k, v in batches.items()}, 2, 0)
    rows += rows2.cpu().tolist()
    assert [int(s) for s in captured] == eager_seeds[3]
    assert len(graph.graphs) == 1 and len(seeds) == 4
    torch.cuda.synchronize()
    assert [(n - s) / 4 for n, s in zip(launches(), start)] == per_step
    assert opt.count == 4 and int(opt.count_t) == 4
    for i, (got, want) in enumerate(zip(rows, eager_rows)):
        for k, w in want.items():
            g = got[names.index(k)]
            assert math.isclose(g, w, rel_tol=1e-4 if i < 2 else 1e-3, abs_tol=1e-6), (i, k, g, w)
    errors = _step_two_errors(second, eager_states[1], eager_states[0], opt.b1)
    assert errors["grad"] <= 1e-4 and errors["left_out"] <= 0.1, errors
    assert errors["weights"] <= 1e-3 and errors["ema"] <= 1e-3, errors


def _train_state(model, opt, ema) -> dict:
    return {"weights": {n: p.detach().double().cpu() for n, p in zip(opt.names, opt.params)},
            "mu": {n: m.double().cpu() for n, m in zip(opt.names, opt.mu)},
            "nu": {n: m.double().cpu() for n, m in zip(opt.names, opt.nu)},
            "ema": {n: e.double().cpu() for n, e in zip(opt.names, ema)}}


def _step_two_errors(got: dict, want: dict, first: dict, b1: float) -> dict:
    """Step 2 of two runs from the same state after step 1 (`first`), as
    ``chip_smoke._second_step_problems`` holds it: the gradient of step 2,
    (mu2 - b1 mu1) / (1 - b1), as one vector (rel-L2); the updates of the
    weights and the EMA since `first` as one vector each over the elements
    whose first and second moments agree to 1e-3 relative (Adam makes a
    full-rate step of a gradient that is zero to rounding, whose sign the
    order of a sum decides), and the share left out."""
    names = list(want["mu"])
    keep = {n: (((got["mu"][n] - want["mu"][n]).abs() <= 1e-3 * want["mu"][n].abs())
                & ((got["nu"][n] - want["nu"][n]).abs() <= 1e-3 * want["nu"][n].abs()))
            for n in names}

    def rel(a, b):
        a, b = torch.cat(a), torch.cat(b)
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    def grad(state):
        return [((state["mu"][n] - b1 * first["mu"][n]) / (1 - b1)).ravel() for n in names]

    out = {"grad": rel(grad(got), grad(want)),
           "left_out": sum(int((~k).sum()) for k in keep.values())
           / sum(k.numel() for k in keep.values())}
    for part in ("weights", "ema"):
        out[part] = rel([(got[part][n] - first[part][n])[keep[n]] for n in names],
                        [(want[part][n] - first[part][n])[keep[n]] for n in names])
    return out
