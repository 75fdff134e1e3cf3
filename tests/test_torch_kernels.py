"""The PyTorch port's CUDA kernels and their ctypes bindings.

On any host: every C entry in ``csrc/`` takes exactly the argument types its
Python wrapper declares (a mismatch would cut pointers or shift arguments,
and no compiler checks a ctypes call), and a wrapper given a tensor on a
device it has no kernel for raises instead of falling back.

On any host also: ``kv_end`` (the last unmasked key the attention kernels
stop at) on CPU tensors, the row alignment the bf16 attention kernels need,
and that the NaN keys the card tests place past ``kv_end`` would show a
kernel that read them.

On a CUDA card (marked ``gpu``; they skip elsewhere): each kernel agrees with
its plain version, in f32 within relative-L2 1e-5 and in bf16 within 2e-2 of
the plain version run in f32 on the same bf16-rounded inputs (attention
forward and backward, dropout included: the same seed gives the same mask;
masks with no valid key, with holes and at tile edges, T off the tiles,
dh 64 and 128, q, k, v as views of the fused projection; NaN keys and
values in the tiles past kv_end, which the kernels must not read, and dK and
dV exactly 0 there);
MAS exactly; CTC loss within relative 1e-5 and its gradient within max-abs
1e-5. Each counts one launch per kernel launch, and each wrapper raises on a
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
    kv_end,
)
from fastspeech2_lightning_tpu_torch.ops.ctc import (
    ctc_alpha,
    ctc_alpha_reference,
    ctc_beta_grad,
    ctc_beta_grad_reference,
)
from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference
from fastspeech2_lightning_tpu_torch.ops.vocoder_resblocks import (
    fused_mrf_stage,
    mrf_conv,
    mrf_stage_reference,
    prepare_stage_weights,
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
    ("ctc_banded_lse", "ctc_beta_grad", ctc._BETA_ARGTYPES),
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
        ctc_beta_grad(la, la, lens, lens, lens.float(), lens.float())
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


@pytest.mark.gpu
@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrf_stage_kernel_matches_plain_version(cuda, C, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    blocks = []
    for k in KS:
        p = {}
        for i in range(3):
            for name in ("convs1", "convs2"):
                p[f"{name}.{i}.weight"] = (torch.randn(C, C, k, device=cuda, generator=g)
                                           / math.sqrt(k * C))
                p[f"{name}.{i}.bias"] = 0.1 * torch.randn(C, device=cuda, generator=g)
        blocks.append(p)
    x = torch.randn(2, 300, C, device=cuda, generator=g).to(dtype)
    flat = prepare_stage_weights(blocks, KS, DILS, dtype)
    before = mrf_conv.launches
    out = fused_mrf_stage(x, flat, KS, DILS)
    torch.cuda.synchronize()
    assert mrf_conv.launches == before + 18
    ref_blocks = [{n: w.to(dtype).float() for n, w in p.items()} for p in blocks]
    want = mrf_stage_reference(x.float(), ref_blocks, KS, DILS)
    assert _rel(out, want) <= _tol(dtype)


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
@pytest.mark.parametrize("B,T,L", [(4, 300, 40), (3, 160, 1000), (2, 2048, 160)])
def test_mas_kernel_equals_plain_version(cuda, B, T, L):
    g = torch.Generator(device=cuda).manual_seed(2)
    la = torch.log_softmax(torch.randn(B, T, L, device=cuda, generator=g), -1)
    la[0, :, 1::3] = la[0, :, :1]  # exact ties between neighbours
    in_lens = torch.tensor([L, max(L // 2, 1), 7, 1][:B], device=cuda)
    out_lens = torch.tensor([T, T - 13, max(T // 3, 7), 5][:B], device=cuda)
    before = mas_width1.launches
    hard, dur = mas_width1(la, in_lens, out_lens)
    torch.cuda.synchronize()
    assert mas_width1.launches == before + 1
    want_hard, want_dur = mas_width1_reference(la, in_lens, out_lens)
    assert torch.equal(hard, want_hard) and torch.equal(dur, want_dur)
    assert torch.equal(dur.sum(1).cpu(), out_lens.int().cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,L", [(3, 120, 20), (2, 300, 160)])
def test_ctc_kernels_match_plain_version(cuda, B, T, L):
    g = torch.Generator(device=cuda).manual_seed(3)
    in_lens = torch.tensor([L, L - 5, 3][:B], device=cuda)
    out_lens = torch.tensor([T, T - 17, 9][:B], device=cuda)
    logits = torch.randn(B, T, L + 1, device=cuda, generator=g)
    logits = torch.where(torch.arange(L + 1, device=cuda) > in_lens[:, None, None],
                         ctc.NEG_INF, logits)
    lp = torch.log_softmax(logits, -1)
    a0, b0 = ctc_alpha.launches, ctc_beta_grad.launches
    alphas = ctc_alpha(lp, out_lens)
    want_alphas = ctc_alpha_reference(lp, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    want_ll = ctc._final_ll(want_alphas[:, -1], in_lens)
    assert float(((ll - want_ll).abs() / want_ll.abs()).max()) <= 1e-5
    gvec = torch.rand(B, device=cuda, generator=g)
    grad = ctc_beta_grad(lp, alphas, in_lens, out_lens, ll, gvec)
    torch.cuda.synchronize()
    assert (ctc_alpha.launches, ctc_beta_grad.launches) == (a0 + 1, b0 + 1)
    want = ctc_beta_grad_reference(lp, want_alphas, in_lens, out_lens, want_ll, gvec)
    assert float((grad - want).abs().max()) <= 1e-5


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
