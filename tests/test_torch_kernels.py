"""The PyTorch port's CUDA kernels and their ctypes bindings.

On any host: every C entry in ``csrc/`` takes exactly the argument types its
Python wrapper declares (a mismatch would cut pointers or shift arguments,
and no compiler checks a ctypes call), and a wrapper given a tensor on a
device it has no kernel for raises instead of falling back.

On a CUDA card (marked ``gpu``; they skip elsewhere): each kernel agrees with
its plain version, in f32 within relative-L2 1e-5 and in bf16 within 2e-2 of
the plain version run in f32 on the same bf16-rounded inputs (attention
forward and backward, dropout included: the same seed gives the same mask);
MAS exactly; CTC loss within relative 1e-5 and its gradient within max-abs
1e-5. Each counts one launch per kernel launch, and each wrapper raises on a
shape its kernel does not take. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import ctypes
import math
import re

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
