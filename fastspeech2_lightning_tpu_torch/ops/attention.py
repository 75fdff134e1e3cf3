"""Attention forward with an additive key bias: the conformer's eval path.

    O = softmax(sm_scale * Q K^T + key_bias[b, None, :]) V

``attention_fwd`` takes q, k, v [B, H, T, dh] (any strides with dh
contiguous) and key_bias [B, T] (0 valid, NEG_INF padded). A CUDA tensor
launches the kernel in ``csrc/attention_fwd.cu`` (or raises); a CPU tensor
goes to ``attention_reference``, its plain PyTorch version.

The kernel replaces the library Pallas flash attention the JAX package's eval
conformer calls on TPU (``models/conformer.py:142``) and
``ops/attention_dropout.py:167 _attention_fwd_impl`` at p = 0. Its bound and
design are in the CUDA source's header.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e9

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_DH = (64, 128)


def attention_reference(q, k, v, key_bias, sm_scale: float) -> torch.Tensor:
    """Plain version: f32 scores, softmax, probabilities cast to the input
    dtype, then P V (the JAX einsum path, ``conformer.py:177-186``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
)


def attention_fwd(q, k, v, key_bias, sm_scale: float) -> torch.Tensor:
    """[B, H, T, dh] attention output in q's dtype."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_bias, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    B, H, T, dh = q.shape
    if dh not in _SUPPORTED_DH:
        raise ValueError(f"attention_fwd: head dim {dh} not in {_SUPPORTED_DH}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention_fwd: dtype {q.dtype} not supported")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention_fwd: {name} must match q in shape/dtype/device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"attention_fwd: {name} needs a contiguous head dim")
    if key_bias.shape != (B, T):
        raise ValueError(f"attention_fwd: key_bias must be [B, T] = {(B, T)}")
    key_bias = key_bias.to(device=q.device, dtype=torch.float32).contiguous()
    # output laid out [B, T, H, dh] so the caller's merge of heads is a view
    o = torch.empty((B, T, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)

    from ..kernels import build

    lib = build.load("attention_fwd", {"attention_fwd": _ARGTYPES})
    err = lib.attention_fwd(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), o.data_ptr(),
        B, H, T, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        sm_scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "attention_fwd")
    attention_fwd.launches += 1
    return o


attention_fwd.launches = 0
