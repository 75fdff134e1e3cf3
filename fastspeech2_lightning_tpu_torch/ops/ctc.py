"""Alignment losses: CTC forward-sum and binarization (counterpart of the JAX
package's ``ops/ctc.py``).

``ctc_forward_sum`` runs the alpha scan over blank-interleaved states alone
when no gradient is wanted (``ctc_alpha``). When one is, it is a
``torch.autograd.Function`` whose forward runs the alpha and beta scans side
by side (``ctc_alpha_beta``, one launch) and whose backward is the posterior
gradient d(-ll)/dy_t(c) = -sum over states s with label c of
exp(alpha + beta - ll) from their rows (``ctc_grad``). Each wrapper launches
its CUDA kernel in ``csrc/ctc_banded_lse.cu`` (which replaces
``ops/ctc_pallas.py:120 banded_lse_scan_pallas``) for CUDA tensors, or
raises, and runs its plain version for CPU tensors. Padded frames
(t >= out_len) emit blank with certainty, so alpha at T-1 equals alpha at
out_len-1; they get no gradient. Labels are the text positions 1..in_len, so
every skip transition is legal.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e15
MAX_S = 2048  # states per item the kernels take (112 a warp, at most 19 warps)


def _state_labels(L: int, device) -> torch.Tensor:
    s = torch.arange(2 * L + 1, device=device)
    return torch.where(s % 2 == 1, (s + 1) // 2, 0)


def _padded(out_lens, T: int, dev) -> torch.Tensor:
    """[B, T, 1]: frame t of item b is padding (t >= out_len)."""
    return torch.arange(T, device=dev)[None, :, None] >= out_lens.to(dev)[:, None, None]


def _emissions(logprobs, out_lens) -> torch.Tensor:
    """[B, T, S] state emissions with padded frames forced to blank."""
    B, T, Lp1 = logprobs.shape
    dev = logprobs.device
    blank = torch.arange(Lp1, device=dev)[None, None, :] == 0
    y = torch.where(_padded(out_lens, T, dev), torch.where(blank, 0.0, NEG_INF),
                    logprobs.float())
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


def ctc_beta_reference(logprobs, in_lens, out_lens) -> torch.Tensor:
    """Plain version of the beta scan: betas [B, T, S] f32."""
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
    return torch.stack(betas, 1)


def ctc_grad_reference(alphas, betas, out_lens, ll, g) -> torch.Tensor:
    """Plain version of the posterior gradient d(g . -ll)/d logprobs: [B, T, L+1]."""
    gamma = torch.exp(torch.clamp(alphas + betas - ll.float()[:, None, None], -80.0, 0.0))
    grad = torch.cat([gamma[:, :, 0::2].sum(-1, keepdim=True), gamma[:, :, 1::2]], dim=-1)
    grad = torch.where(_padded(out_lens, alphas.shape[1], alphas.device), 0.0, -grad)
    return grad * g.float()[:, None, None]


_P, _I = ctypes.c_void_p, ctypes.c_int
_ALPHA_ARGTYPES = [_P] * 3 + [_I] * 3 + [_P]
_ALPHA_BETA_ARGTYPES = [_P] * 5 + [_I] * 3 + [_P]
_GRAD_ARGTYPES = [_P] * 6 + [_I] * 3 + [_P]
_SIGNATURES = {"ctc_alpha": _ALPHA_ARGTYPES, "ctc_alpha_beta": _ALPHA_BETA_ARGTYPES,
               "ctc_grad": _GRAD_ARGTYPES}


def _check(name: str, x, S: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if S > MAX_S:
        raise ValueError(f"{name}: {S} states > {MAX_S}")


def _f32(x, dev):
    return x.to(device=dev, dtype=torch.float32).contiguous()


def _i32(x, dev):
    return x.to(device=dev, dtype=torch.int32).contiguous()


def _launch(entry: str, dev, *args) -> None:
    from ..kernels import build

    lib = build.load("ctc_banded_lse", _SIGNATURES)
    err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, entry)


def ctc_alpha(logprobs, out_lens) -> torch.Tensor:
    """alphas [B, T, 2L+1] f32 for logprobs [B, T, L+1] (column 0 blank)."""
    if logprobs.device.type == "cpu":
        return ctc_alpha_reference(logprobs, out_lens)
    B, T, Lp1 = logprobs.shape
    _check("ctc_alpha", logprobs, 2 * Lp1 - 1)
    dev = logprobs.device
    lp, out_lens = _f32(logprobs, dev), _i32(out_lens, dev)
    alphas = torch.empty((B, T, 2 * Lp1 - 1), dtype=torch.float32, device=dev)
    _launch("ctc_alpha", dev, lp.data_ptr(), out_lens.data_ptr(), alphas.data_ptr(), B, T,
            Lp1 - 1)
    ctc_alpha.launches += 1
    return alphas


ctc_alpha.launches = 0


def ctc_alpha_beta(logprobs, in_lens, out_lens) -> tuple:
    """(alphas, betas), each [B, T, 2L+1] f32, from one launch."""
    if logprobs.device.type == "cpu":
        return (ctc_alpha_reference(logprobs, out_lens),
                ctc_beta_reference(logprobs, in_lens, out_lens))
    B, T, Lp1 = logprobs.shape
    _check("ctc_alpha_beta", logprobs, 2 * Lp1 - 1)
    dev = logprobs.device
    lp = _f32(logprobs, dev)
    in_lens, out_lens = _i32(in_lens, dev), _i32(out_lens, dev)
    rows = torch.empty((2, B, T, 2 * Lp1 - 1), dtype=torch.float32, device=dev)
    _launch("ctc_alpha_beta", dev, lp.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(), B, T, Lp1 - 1)
    ctc_alpha_beta.launches += 1
    return rows[0], rows[1]


ctc_alpha_beta.launches = 0


def ctc_grad(alphas, betas, out_lens, ll, g) -> torch.Tensor:
    """d(g . -ll)/d logprobs, [B, T, L+1] f32, from the alpha and beta rows."""
    if alphas.device.type == "cpu":
        return ctc_grad_reference(alphas, betas, out_lens, ll, g)
    B, T, S = alphas.shape
    _check("ctc_grad", alphas, S)
    if betas.shape != alphas.shape or S % 2 == 0:
        raise ValueError("ctc_grad: alphas and betas must both be [B, T, 2L+1]")
    dev = alphas.device
    alphas, betas = _f32(alphas, dev), _f32(betas, dev)
    out_lens, ll, g = _i32(out_lens, dev), _f32(ll, dev), _f32(g, dev)
    grad = torch.empty((B, T, (S + 1) // 2), dtype=torch.float32, device=dev)
    _launch("ctc_grad", dev, alphas.data_ptr(), betas.data_ptr(), out_lens.data_ptr(),
            ll.data_ptr(), g.data_ptr(), grad.data_ptr(), B, T, (S - 1) // 2)
    ctc_grad.launches += 1
    return grad


ctc_grad.launches = 0


class _CTCForwardSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logprobs, in_lens, out_lens):
        alphas, betas = ctc_alpha_beta(logprobs, in_lens, out_lens)
        ll = _final_ll(alphas[:, -1], in_lens)
        ctx.save_for_backward(alphas, betas, out_lens, ll)
        ctx.dtype = logprobs.dtype
        return -ll

    @staticmethod
    def backward(ctx, g):
        grad = ctc_grad(*ctx.saved_tensors, g)
        return grad.to(ctx.dtype), None, None


def ctc_forward_sum(logprobs, in_lens, out_lens) -> torch.Tensor:
    """Exact CTC negative log-likelihood per example, labels = 1..in_len;
    logprobs [B, T, L+1] with column 0 the blank. The beta scan runs (beside
    the alpha scan) only when the result will need a gradient."""
    if torch.is_grad_enabled() and logprobs.requires_grad:
        return _CTCForwardSum.apply(logprobs, in_lens, out_lens)
    return -_final_ll(ctc_alpha(logprobs, out_lens)[:, -1], in_lens)


def _ctc_per_example(attn_logprob, in_lens, out_lens, blank_logprob):
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
    return per_example / torch.clamp(in_lens.to(dev).float(), min=1.0)


def attention_ctc_loss(attn_logprob, in_lens, out_lens, blank_logprob: float = -1.0,
                       sample_weight=None) -> torch.Tensor:
    """Forward-sum alignment loss over [B, T_mel, L_text] attention scores
    (``ops/ctc.py:232-258``): a blank column, key columns past in_len at
    NEG_INF, log-softmax, CTC with zero_infinity and per-target-length mean;
    zero-weight rows leave the mean."""
    per_example = _ctc_per_example(attn_logprob, in_lens, out_lens, blank_logprob)
    if sample_weight is None:
        return per_example.mean()
    w = sample_weight.float()
    return (per_example * w).sum() / torch.clamp(w.sum(), min=1.0)


def attention_ctc_loss_parts(attn_logprob, in_lens, out_lens, sample_weight,
                             blank_logprob: float = -1.0):
    """(numerator, denominator) of ``attention_ctc_loss`` with weights: the
    loss is numerator / max(denominator, 1), and a data-parallel step sums
    the denominator over the data group first."""
    per_example = _ctc_per_example(attn_logprob, in_lens, out_lens, blank_logprob)
    w = sample_weight.float()
    return (per_example * w).sum(), w.sum()


def attention_binarization_loss(hard_attention, soft_attention, eps: float = 1e-12,
                                sample_weight=None) -> torch.Tensor:
    """-sum(log soft | hard == 1) / sum(hard) (``ops/ctc.py:261-275``)."""
    num, den = attention_binarization_loss_parts(hard_attention, soft_attention, eps,
                                                 sample_weight)
    return num / torch.clamp(den, min=1.0)


def attention_binarization_loss_parts(hard_attention, soft_attention, eps: float = 1e-12,
                                      sample_weight=None):
    """(numerator, denominator) of ``attention_binarization_loss``."""
    log_soft = torch.log(torch.clamp(soft_attention, min=eps))
    hard = hard_attention
    if sample_weight is not None:
        w = sample_weight.to(hard.dtype)
        hard = hard * w.reshape((-1,) + (1,) * (hard.ndim - 1))
    return -(log_soft * hard).sum(), hard.sum()
