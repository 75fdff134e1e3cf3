"""Kernels B, C and A at the shapes ``chip_smoke.py`` phase 33 times past
one cluster's reach, beside what the phase leaves out for its time: the
plain versions (seconds a call there) and ``F.ctc_loss``.

At ``chip_smoke.PANEL_MAS_TIMED`` B's device ms and its plain version once
(the path held bit for bit); at ``PANEL_CTC_TIMED`` C's three entries'
device ms, their plain versions once (the alpha and beta chains apart) and
``F.ctc_loss``'s forward and forward + backward (its kernels in a profiler
trace); at ``PANEL_ATTENTION``, p ``PANEL_P``, A's device ms at p 0.2 and 0,
SDPA's, and the plain version's forward over every row (``PANEL_ROWS`` rows
a pass, the mask of those rows alone). Inputs are drawn as phase 33 draws
them. Run it from the root of a checkout:

    python tools/panel_timing.py

It prints the card, one line a kernel and the rows as JSON (``PANEL_TIMING``)."""

import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402


def mas_row() -> dict:
    import torch

    from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1, mas_width1_reference

    B, T, L = smoke.PANEL_MAS_TIMED
    gen, in_lens, out_lens = smoke.chain_lengths(B, T, L)
    la = torch.log_softmax(torch.randn(B, T, L, device="cuda", generator=gen), -1)
    got = mas_width1(la, in_lens, out_lens)
    want = []
    plain = smoke.time_ms(lambda: want.append(mas_width1_reference(la, in_lens, out_lens)),
                          warmup=0, iters=1)
    smoke.check(all(torch.equal(a, b) for a, b in zip(got, want[0])),
                f"mas_width1 {B, T, L}: path differs from the plain version")
    del got, want
    row = dict(shape=[B, T, L], device_ms=smoke.device_ms(
        lambda: mas_width1(la, in_lens, out_lens), iters=5), plain_ms=plain)
    smoke.log(f"B at {B, T, L}: device {row['device_ms']:.4f}, plain {plain:.1f} ms (bit-exact)")
    del la
    torch.cuda.empty_cache()
    return row


def ctc_rows() -> dict:
    import torch
    import torch.nn.functional as F

    from fastspeech2_lightning_tpu_torch.ops import ctc

    B, T, L = smoke.PANEL_CTC_TIMED
    gen, in_lens, out_lens = smoke.chain_lengths(B, T, L)
    logits = torch.cat([torch.full((B, T, 1), -1.0, device="cuda"),
                        torch.randn(B, T, L, device="cuda", generator=gen)], -1)
    lp = torch.log_softmax(torch.where(torch.arange(L + 1, device="cuda")
                                       > in_lens[:, None, None], ctc.NEG_INF, logits), -1)
    del logits
    gvec = torch.rand(B, device="cuda", generator=gen)
    alphas, betas = ctc.ctc_alpha_beta(lp, in_lens, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    fns = {"fwd": lambda: ctc.ctc_alpha(lp, out_lens),
           "fwd_grad": lambda: ctc.ctc_alpha_beta(lp, in_lens, out_lens),
           "bwd": lambda: ctc.ctc_grad(alphas, betas, out_lens, ll, gvec)}
    rows = {k: dict(shape=[B, T, L], device_ms=smoke.device_ms(fn, iters=3))
            for k, fn in fns.items()}
    plain_a = smoke.time_ms(lambda: ctc.ctc_alpha_reference(lp, out_lens), warmup=0, iters=1)
    plain_b = smoke.time_ms(lambda: ctc.ctc_beta_reference(lp, in_lens, out_lens), warmup=0,
                            iters=1)
    rows["fwd"]["plain_ms"], rows["fwd_grad"]["plain_ms"] = plain_a, plain_a + plain_b
    rows["bwd"]["plain_ms"] = smoke.time_ms(
        lambda: ctc.ctc_grad_reference(alphas, betas, out_lens, ll, gvec), warmup=1, iters=2)
    del alphas, betas
    torch.cuda.empty_cache()
    targets = torch.arange(1, L + 1, device="cuda").expand(B, L)
    lp_tbc = lp.transpose(0, 1).contiguous()
    del lp
    lp_g = lp_tbc.clone().requires_grad_(True)
    lib_fwd = smoke.kernels_ms(lambda: F.ctc_loss(lp_tbc, targets, out_lens, in_lens, blank=0,
                                                  reduction="none", zero_infinity=True), iters=2)
    lib_fwd_bwd = smoke.kernels_ms(lambda: torch.autograd.grad(F.ctc_loss(
        lp_g, targets, out_lens, in_lens, blank=0, reduction="none", zero_infinity=True),
        lp_g, gvec), iters=2)
    rows["fwd"]["library_device_ms"] = rows["fwd_grad"]["library_device_ms"] = lib_fwd
    rows["bwd"]["library_device_ms"] = lib_fwd_bwd
    smoke.log(f"C at {B, T, L}: " + ", ".join(
        f"{k} device {r['device_ms']:.4f} plain {r['plain_ms']:.1f}" for k, r in rows.items())
        + f"; F.ctc_loss forward {lib_fwd}, forward+backward {lib_fwd_bwd}")
    del lp_tbc, lp_g
    torch.cuda.empty_cache()
    return rows


def attention_row() -> dict:
    import torch
    import torch.nn.functional as F

    from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd, dropout_keep_mask

    B, H, T, dh = smoke.PANEL_ATTENTION
    p = smoke.PANEL_P
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 233)
    q, k, v = (torch.randn(B, H, T, dh, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.zeros(B, T, device="cuda")
    seed = torch.tensor([2333], dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for r0 in range(0, T, smoke.PANEL_ROWS):
            qc = q[:, :, r0:r0 + smoke.PANEL_ROWS].float()
            prob = torch.softmax(torch.matmul(qc, kf.transpose(-1, -2)) * scale
                                 + bias[:, None, None, :], dim=-1)
            keep = dropout_keep_mask(int(seed), B, H, T, p, device="cuda",
                                     rows=(r0, r0 + qc.shape[2]))
            torch.matmul(torch.where(keep, prob / (1.0 - p), 0.0), vf)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    del kf, vf, prob, keep
    torch.cuda.empty_cache()
    row = dict(shape=[B, H, T, dh], p=p, plain_ms=plain,
               device_ms=smoke.device_ms(lambda: attention_fwd(
                   q, k, v, bias, scale, p=p, seed=seed, with_lse=True), iters=5),
               p0_device_ms=smoke.device_ms(lambda: attention_fwd(
                   q, k, v, bias, scale, with_lse=True), iters=5),
               library_device_ms=smoke.device_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, dropout_p=p, scale=scale), iters=5))
    smoke.log(f"A at {B, H, T, dh} p {p}: device {row['device_ms']:.4f} (p 0 "
              f"{row['p0_device_ms']:.4f}), SDPA {row['library_device_ms']:.4f}, plain forward "
              f"over every row {plain:.1f} ms")
    return row


def main() -> None:
    smi = smoke.phase_device()
    print(smi, flush=True)
    smoke.phase_build()
    out = dict(card=smi, mas=mas_row(), ctc=ctc_rows(), attention=attention_row())
    print("PANEL_TIMING " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
