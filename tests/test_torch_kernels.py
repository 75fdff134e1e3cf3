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
dh 64 and 128, q, k, v as views of the fused projection; NaN keys and
values in the tiles past kv_end, which the kernels must not read, and dK and
dV exactly 0 there);
the MRF conv in f32 within 5e-5, since it multiplies f32 inputs as split
bf16 pairs on the tensor cores, at T off its 128-row tile and under its halo,
with each epilogue mode, and on the edge rows alone, and its stage at the
three B = 1 shapes of a low-latency window of the V1 vocoder, and raising
under autograd before it launches;
MAS exactly; CTC loss within relative 1e-5 and its gradient within max-abs
1e-5; kernel A as the op ``fs2t::attention_fwd`` through
``torch.library.opcheck``, and a one-layer Conformer exported with
``torch.export``, saved, loaded and run, launching A and equal to eager. Each counts one launch per kernel launch, and each wrapper raises on a
shape its kernel does not take. This file imports no JAX, so it also runs on a
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
    ("attention_bwd", "attention_bwd", attention._BWD_ARGTYPES),
    ("mas_width1", "mas_width1", mas._ARGTYPES),
    ("ctc_banded_lse", "ctc_alpha", ctc._ALPHA_ARGTYPES),
    ("ctc_banded_lse", "ctc_alpha_beta", ctc._ALPHA_BETA_ARGTYPES),
    ("ctc_banded_lse", "ctc_grad", ctc._GRAD_ARGTYPES),
    ("mrf_conv", "mrf_conv", vocoder_resblocks._ARGTYPES),
])
def test_c_entries_match_declared_argtypes(source, entry, argtypes):
    assert _c_params(source, entry) == list(argtypes)


def test_every_source_is_built_for_sm_90a():
    assert build.all_sources() == ["attention_bwd", "attention_fwd", "ctc_banded_lse",
                                   "mas_width1", "mrf_conv"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


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


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,dh", [(3, 2, 37, 64), (3, 2, 160, 128), (2, 2, 1000, 128),
                                      (8, 4, 160, 64)])
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
    B, T, H, dh = 2, 70, 2, 64
    qkv = torch.randn(B, T, 3, H, dh, device=cuda)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.zeros(B, T, device=cuda)
    out = attention_fwd(q, k, v, bias, 0.125)
    want = attention_reference(q, k, v, bias, 0.125)
    assert _rel(out, want) <= 1e-5
    x = torch.randn(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention_fwd(x, x, x, torch.zeros(1, 16, device=cuda), 0.125)


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


def _check_fwd_bwd(cuda, q, k, v, bias, dtype, p, ref_kv=None):
    """Both kernels against the plain version in f32 on the same inputs
    (or on `ref_kv` in place of k and v), the same seed (so the same dropout
    mask)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    do = torch.randn(q.shape, device=cuda, generator=g).to(dtype)
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda)
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = attention_fwd(q, k, v, bias, scale, p=p, seed=seed, with_lse=True)
    grads = attention_bwd(q, k, v, bias, seed, p, scale, out, lse, do)
    torch.cuda.synchronize()
    k, v = ref_kv or (k, v)
    qf, kf, vf = q.float(), k.float(), v.float()
    assert _rel(out, attention_dropout_reference(qf, kf, vf, bias, seed, p, scale)) <= _tol(dtype)
    want = attention_bwd_reference(qf, kf, vf, bias, seed, p, scale, do.float())
    for got, ref in zip(grads, want):
        assert got.dtype == dtype
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
@pytest.mark.parametrize("dh", [64, 128])
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
@pytest.mark.parametrize("dh", [64, 128])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_offsets_match_plain_version(cuda, T, dtype):
    """The training Function (A forward, A′ backward) at nonzero offsets
    against autograd through the plain version at the same offsets."""
    B, H, dh, p = 2, 2, 64, 0.2
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
@pytest.mark.parametrize("T", [37, 1000, 2047])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_attention_kernels_on_T_off_the_tiles(cuda, T, dh, dtype, p):
    lens = [T, max(T - 37, 1)]
    bias = _bias(np.stack([_segments(T, (0, n)) for n in lens])).to(cuda)
    q, k, v = _fused_qkv(cuda, 2, T, 2, dh, dtype, seed=T)
    _check_fwd_bwd(cuda, q, k, v, bias, dtype, p)


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


def _stage_blocks(C, device, seed=1):
    """One V1 stage's resblocks in torch Conv1d layout, fan-in scaled."""
    g = torch.Generator(device=device).manual_seed(seed)
    blocks = []
    for k in KS:
        p = {}
        for i in range(3):
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
    (16, KS, DILS, False), (256, KS, DILS, False), (96, KS, DILS, False),
    (64, (4, 7, 11), DILS, False), (64, (3, 7, 13), DILS, False),
    (64, (3,), ((1, 26),), False),
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
@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(2, 300), (1, 37), (1, 127), (1, 129), (1, 257), (1, 1000)])
def test_mrf_stage_kernel_matches_plain_version(cuda, C, dtype, B, T):
    blocks = _stage_blocks(C, cuda)
    g = torch.Generator(device=cuda).manual_seed(T)
    x = torch.randn(B, T, C, device=cuda, generator=g).to(dtype)
    flat = prepare_stage_weights(blocks, KS, DILS, dtype)
    before = mrf_conv.launches
    out = fused_mrf_stage(x, flat, KS, DILS)
    torch.cuda.synchronize()
    assert mrf_conv.launches == before + 18
    ref_blocks = [{n: w.to(dtype).float() for n, w in p.items()} for p in blocks]
    want = mrf_stage_reference(x.float(), ref_blocks, KS, DILS)
    assert out.dtype == dtype and out.shape == x.shape
    assert _rel(out, want) <= _mrf_tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", [WRITE, ACCUMULATE, FINISH])
@pytest.mark.parametrize("K,dil", [(3, 1), (7, 3), (11, 5)])
def test_mrf_conv_modes_and_edges_match_plain_version(cuda, C, dtype, mode, K, dil):
    """One conv with `residual is out`, each epilogue mode; the whole output
    and the first and last half * dilation rows (where SAME padding shows) on
    their own."""
    B, T = 2, 300
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(B, T, C, device=cuda, generator=g).to(dtype)
    res = torch.randn(B, T, C, device=cuda, generator=g).to(dtype)
    acc0 = torch.randn(B, T, C, device=cuda, generator=g)
    w32 = torch.randn(K, C, C, device=cuda, generator=g) / math.sqrt(K * C)
    bias = (0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    w = split_bf16(w32) if dtype == torch.float32 else w32.to(torch.bfloat16)
    w_ref = w32 if dtype == torch.float32 else w.float()

    out, acc = res.clone(), acc0.clone()
    mrf_conv(x, w, bias, dil, residual=out, out=out, acc=acc, mode=mode, scale=1 / 3)
    torch.cuda.synchronize()
    want_out, want_acc = res.float(), acc0.clone()
    mrf_conv_reference(x, w_ref, bias, dil, residual=res, out=want_out, acc=want_acc,
                       mode=mode, scale=1 / 3)
    got, want = (acc, want_acc) if mode == ACCUMULATE else (out, want_out)
    edge = (K - 1) // 2 * dil
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
def test_mrf_conv_raises_on_what_the_kernel_does_not_take(cuda):
    def call(C=32, K=3, dil=1, dtype=torch.float32, w=None, alias=False):
        x = torch.zeros(1, 64, C, device=cuda, dtype=dtype)
        if w is None:
            w = torch.zeros((2, K, C, C) if dtype == torch.float32 else (K, C, C),
                            device=cuda, dtype=torch.bfloat16)
        bias = torch.zeros(C, device=cuda, dtype=dtype)
        mrf_conv(x, w, bias, dil, out=x if alias else torch.empty_like(x))

    call()
    with pytest.raises(ValueError, match="must not alias"):
        call(alias=True)
    for C in (16, 48, 256):
        with pytest.raises(ValueError, match="not in"):
            call(C=C)
    with pytest.raises(ValueError, match="kernel size"):
        call(K=4)
    with pytest.raises(ValueError, match="kernel size"):
        call(K=11, dil=6)
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
@pytest.mark.parametrize("B,H,T,dh", [(3, 2, 37, 64), (2, 2, 200, 128)])
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
                                   (2, 100, 512), (2, 100, 256), (2, 100, 257)])
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
                                   (4, 64, 1023), (4, 50, 1), (5, 9, 300)])
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
    q = torch.randn(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention_fwd(q, q, q, torch.zeros(1, 16, device=cuda), 0.125, p=0.1,
                      seed=torch.zeros(1, dtype=torch.int32, device=cuda))
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="text length"):
        mas_width1(torch.zeros(1, 4, 1025, device=cuda), lens, lens)
    with pytest.raises(ValueError, match="states"):
        ctc_alpha(torch.zeros(1, 4, 1026, device=cuda), lens)
