"""The PyTorch port's CUDA kernels and their ctypes bindings.

On any host: every C entry in ``csrc/`` takes exactly the argument types its
Python wrapper declares (a mismatch would cut pointers or shift arguments,
and no compiler checks a ctypes call), and a wrapper given a tensor on a
device it has no kernel for raises instead of falling back.

On a CUDA card (marked ``gpu``; they skip elsewhere): each kernel agrees with
its plain version, in f32 within relative-L2 1e-5 and in bf16 within 2e-2 of
the plain version run in f32 on the same bf16-rounded inputs, and counts one
launch per kernel launch. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import ctypes
import math
import re

import pytest
import torch

from fastspeech2_lightning_tpu_torch.kernels import build
from fastspeech2_lightning_tpu_torch.ops import attention, vocoder_resblocks
from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, attention_reference
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
    ("attention_fwd", "attention_fwd", attention._ARGTYPES),
    ("mrf_conv", "mrf_conv", vocoder_resblocks._ARGTYPES),
])
def test_c_entries_match_declared_argtypes(source, entry, argtypes):
    assert _c_params(source, entry) == list(argtypes)


def test_every_source_is_built_for_sm_90a():
    assert build.all_sources() == ["attention_fwd", "mrf_conv"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_wrappers_raise_on_a_device_without_kernel():
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_fwd(q, q, q, torch.empty(1, 8, device="meta"), 0.125)
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
