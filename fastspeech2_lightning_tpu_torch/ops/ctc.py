"""Alignment losses: CTC forward-sum and binarization (counterpart of the JAX
package's ``ops/ctc.py``).

``ctc_forward_sum`` is a ``torch.autograd.Function``: its forward is the
alpha scan over blank-interleaved states (``ctc_alpha``), its backward the
beta scan fused with the posterior gradient
d(-ll)/dy_t(c) = -sum over states s with label c of exp(alpha + beta - ll)
(``ctc_beta_grad``). Each wrapper launches its CUDA kernel in
``csrc/ctc_banded_lse.cu`` (which replaces ``ops/ctc_pallas.py:120
banded_lse_scan_pallas``) for CUDA tensors, or raises, and runs its plain
version for CPU tensors. Padded frames (t >= out_len) emit blank with
certainty, so alpha at T-1 equals alpha at out_len-1; they get no gradient.
Labels are the text positions 1..in_len, so every skip transition is legal.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e15
MAX_S = 2048  # states per item the kernel takes (two per thread)


def _state_labels(L: int, device) -> torch.Tensor:
    s = torch.arange(2 * L + 1, device=device)
    return torch.where(s % 2 == 1, (s + 1) // 2, 0)


def _emissions(logprobs, out_lens) -> torch.Tensor:
    """[B, T, S] state emissions with padded frames forced to blank."""
    B, T, Lp1 = logprobs.shape
    dev = logprobs.device
    padded = torch.arange(T, device=dev)[None, :, None] >= out_lens.to(dev)[:, None, None]
    blank = torch.arange(Lp1, device=dev)[None, None, :] == 0
    y = torch.where(padded, torch.where(blank, 0.0, NEG_INF), logprobs.float())
    return y[:, :, _state_labels(Lp1 - 1, dev)]


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
    return torch.where(m > 0.5 * NEG_INF, out, NEG_INF)


def _shift(x, n: int, fill=NEG_INF):
    """x[:, s - n] (n > 0) or x[:, s + |n|] (n < 0) along the last axis."""
    pad = torch.full_like(x[:, : abs(n)], fill)
    if n > 0:
        return torch.cat([pad, x[:, :-n]], dim=1)
    return torch.cat([x[:, -n:], pad], dim=1)


def ctc_alpha_reference(logprobs, out_lens) -> torch.Tensor:
    """Plain version of the alpha scan: alphas [B, T, S] f32."""
    emis = _emissions(logprobs, out_lens)
    B, T, S = emis.shape
    odd = (torch.arange(S, device=emis.device) % 2 == 1)[None, :]
    prev = torch.full((B, S), NEG_INF, device=emis.device)
    prev[:, 0] = 0.0
    rows = []
    for t in range(T):
        skip = torch.where(odd, _shift(prev, 2), NEG_INF)
        prev = torch.clamp(_lse3(prev, _shift(prev, 1), skip) + emis[:, t], min=NEG_INF)
        rows.append(prev)
    return torch.stack(rows, dim=1)


def _final_states(in_lens, S: int):
    in_lens = in_lens.long()
    return (torch.clamp(2 * in_lens, 0, S - 1), torch.clamp(2 * in_lens - 1, 0, S - 1))


def _final_ll(alpha_last, in_lens) -> torch.Tensor:
    """logsumexp of the two legal final states at T-1 (JAX ``_final_ll``)."""
    s_blank, s_label = _final_states(in_lens.to(alpha_last.device), alpha_last.shape[1])
    a = alpha_last.gather(1, s_blank[:, None])[:, 0]
    b = alpha_last.gather(1, s_label[:, None])[:, 0]
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def ctc_beta_grad_reference(logprobs, alphas, in_lens, out_lens, ll, g) -> torch.Tensor:
    """Plain version of the beta scan and posterior gradient: [B, T, L+1]."""
    emis = _emissions(logprobs, out_lens)
    B, T, S = emis.shape
    dev = emis.device
    s_ids = torch.arange(S, device=dev)
    odd = (s_ids % 2 == 1)[None, :]
    s_blank, s_label = _final_states(in_lens.to(dev), S)
    beta = torch.where((s_ids[None] == s_blank[:, None]) | (s_ids[None] == s_label[:, None]),
                       0.0, NEG_INF)
    betas = [None] * T
    betas[T - 1] = beta
    for t in range(T - 1, 0, -1):
        w = beta + emis[:, t]
        beta = torch.clamp(_lse3(w, _shift(w, -1), torch.where(odd, _shift(w, -2), NEG_INF)),
                           min=NEG_INF)
        betas[t - 1] = beta
    gamma = torch.exp(torch.clamp(alphas + torch.stack(betas, 1) - ll.float()[:, None, None],
                                  -80.0, 0.0))
    grad = torch.cat([gamma[:, :, 0::2].sum(-1, keepdim=True), gamma[:, :, 1::2]], dim=-1)
    padded = torch.arange(T, device=dev)[None, :, None] >= out_lens.to(dev)[:, None, None]
    grad = torch.where(padded, 0.0, -grad)
    return grad * g.float()[:, None, None]


_ALPHA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BETA_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SIGNATURES = {"ctc_alpha": _ALPHA_ARGTYPES, "ctc_beta_grad": _BETA_ARGTYPES}


def _check(name: str, logprobs) -> tuple:
    if logprobs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {logprobs.device}")
    B, T, Lp1 = logprobs.shape
    if 2 * (Lp1 - 1) + 1 > MAX_S:
        raise ValueError(f"{name}: {2 * (Lp1 - 1) + 1} states > {MAX_S}")
    return B, T, Lp1 - 1


def _i32(x, dev):
    return x.to(device=dev, dtype=torch.int32).contiguous()


def ctc_alpha(logprobs, out_lens) -> torch.Tensor:
    """alphas [B, T, 2L+1] f32 for logprobs [B, T, L+1] (column 0 blank)."""
    if logprobs.device.type == "cpu":
        return ctc_alpha_reference(logprobs, out_lens)
    B, T, L = _check("ctc_alpha", logprobs)
    dev = logprobs.device
    lp = logprobs.float().contiguous()
    out_lens = _i32(out_lens, dev)
    alphas = torch.empty((B, T, 2 * L + 1), dtype=torch.float32, device=dev)

    from ..kernels import build

    lib = build.load("ctc_banded_lse", _SIGNATURES)
    err = lib.ctc_alpha(lp.data_ptr(), out_lens.data_ptr(), alphas.data_ptr(), B, T, L,
                        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ctc_alpha")
    ctc_alpha.launches += 1
    return alphas


ctc_alpha.launches = 0


def ctc_beta_grad(logprobs, alphas, in_lens, out_lens, ll, g) -> torch.Tensor:
    """d(g . -ll)/d logprobs, [B, T, L+1] f32."""
    if logprobs.device.type == "cpu":
        return ctc_beta_grad_reference(logprobs, alphas, in_lens, out_lens, ll, g)
    B, T, L = _check("ctc_beta_grad", logprobs)
    dev = logprobs.device
    if alphas.shape != (B, T, 2 * L + 1):
        raise ValueError("ctc_beta_grad: alphas must be [B, T, 2L+1]")
    lp = logprobs.float().contiguous()
    alphas = alphas.float().contiguous()
    in_lens, out_lens = _i32(in_lens, dev), _i32(out_lens, dev)
    ll = ll.float().contiguous()
    g = g.float().contiguous()
    grad = torch.empty((B, T, L + 1), dtype=torch.float32, device=dev)

    from ..kernels import build

    lib = build.load("ctc_banded_lse", _SIGNATURES)
    err = lib.ctc_beta_grad(lp.data_ptr(), alphas.data_ptr(), in_lens.data_ptr(),
                            out_lens.data_ptr(), ll.data_ptr(), g.data_ptr(), grad.data_ptr(),
                            B, T, L, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ctc_beta_grad")
    ctc_beta_grad.launches += 1
    return grad


ctc_beta_grad.launches = 0


class _CTCForwardSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logprobs, in_lens, out_lens):
        alphas = ctc_alpha(logprobs, out_lens)
        ll = _final_ll(alphas[:, -1], in_lens)
        ctx.save_for_backward(logprobs, alphas, in_lens, out_lens, ll)
        return -ll

    @staticmethod
    def backward(ctx, g):
        logprobs, alphas, in_lens, out_lens, ll = ctx.saved_tensors
        grad = ctc_beta_grad(logprobs, alphas, in_lens, out_lens, ll, g)
        return grad.to(logprobs.dtype), None, None


def ctc_forward_sum(logprobs, in_lens, out_lens) -> torch.Tensor:
    """Exact CTC negative log-likelihood per example, labels = 1..in_len;
    logprobs [B, T, L+1] with column 0 the blank."""
    return _CTCForwardSum.apply(logprobs, in_lens, out_lens)


def attention_ctc_loss(attn_logprob, in_lens, out_lens, blank_logprob: float = -1.0,
                       sample_weight=None) -> torch.Tensor:
    """Forward-sum alignment loss over [B, T_mel, L_text] attention scores
    (``ops/ctc.py:232-258``): a blank column, key columns past in_len at
    NEG_INF, log-softmax, CTC with zero_infinity and per-target-length mean;
    zero-weight rows leave the mean."""
    B, T, L = attn_logprob.shape
    dev = attn_logprob.device
    blank = torch.full((B, T, 1), blank_logprob, dtype=torch.float32, device=dev)
    logits = torch.cat([blank, attn_logprob.float()], dim=-1)
    key_ids = torch.arange(L + 1, device=dev)[None, None, :]
    logits = torch.where(key_ids > in_lens.to(dev)[:, None, None], NEG_INF, logits)
    logprobs = torch.log_softmax(logits, dim=-1)

    per_example = ctc_forward_sum(logprobs, in_lens, out_lens)
    per_example = torch.where(torch.isfinite(per_example), per_example, 0.0)
    per_example = torch.where(per_example >= -NEG_INF * 1e-3, 0.0, per_example)
    per_example = per_example / torch.clamp(in_lens.to(dev).float(), min=1.0)
    if sample_weight is None:
        return per_example.mean()
    w = sample_weight.float()
    return (per_example * w).sum() / torch.clamp(w.sum(), min=1.0)


def attention_binarization_loss(hard_attention, soft_attention, eps: float = 1e-12,
                                sample_weight=None) -> torch.Tensor:
    """-sum(log soft | hard == 1) / sum(hard) (``ops/ctc.py:261-275``)."""
    log_soft = torch.log(torch.clamp(soft_attention, min=eps))
    hard = hard_attention
    if sample_weight is not None:
        w = sample_weight.to(hard.dtype)
        hard = hard * w.reshape((-1,) + (1,) * (hard.ndim - 1))
    num = (log_soft * hard).sum()
    den = torch.clamp(hard.sum(), min=1.0)
    return -num / den
