"""Time kernel C (CTC) of commit df5456f, the version before the redesign,
in turns with this checkout's, on one card.

The old kernel had two C entries, `ctc_alpha` (the alpha chain) in the
forward and `ctc_beta_grad` (the beta chain with the gradient) in the
backward; this checkout's forward with a gradient runs `ctc_alpha_beta` and
its backward `ctc_grad`. The script builds the old source from a checkout of
df5456f, checks that its rows and gradient agree with this checkout's, and
times both with `chip_smoke.device_ms` in turns (old, new, new, old) on the
inputs `chip_smoke.py` makes in phase 10 (B 16, T 1024, L 160) and phase 14
(each length bucket of the smoke corpus). It prints one JSON line a shape:
device ms of the gradient-free forward (`fwd`) and of forward + backward
(`fwd_bwd`), the old kernel's as `parent_fwd` and `parent_fwd_bwd`.

    git archive df5456f | tar -x -C _archive/parent
    python tools/ctc_parent_timing.py _archive/parent
"""
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from fastspeech2_lightning_tpu_torch.kernels import build  # noqa: E402
from fastspeech2_lightning_tpu_torch.ops import ctc  # noqa: E402


def old_library(checkout: Path) -> ctypes.CDLL:
    """The old source built into the old checkout's own build folder."""
    src = checkout / c.PORT / "csrc" / "ctc_banded_lse.cu"
    out = checkout / c.PORT / "_build" / "ctc_banded_lse_df5456f.so"
    out.parent.mkdir(exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ctc_alpha.argtypes = [P] * 3 + [I] * 3 + [P]
    lib.ctc_beta_grad.argtypes = [P] * 7 + [I] * 3 + [P]
    return lib


def case(old, B, T, L, in_lens, out_lens, seed) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    in_lens = torch.as_tensor(in_lens, device="cuda").long()
    out_lens = torch.as_tensor(out_lens, device="cuda").long()
    attn = torch.randn(B, T, L, device="cuda", generator=g)
    logits = torch.cat([torch.full((B, T, 1), -1.0, device="cuda"), attn], -1)
    lp = torch.log_softmax(torch.where(torch.arange(L + 1, device="cuda") > in_lens[:, None, None],
                                       ctc.NEG_INF, logits), -1)
    gvec = torch.rand(B, device="cuda", generator=g)
    alphas, betas = ctc.ctc_alpha_beta(lp, in_lens, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    grad = ctc.ctc_grad(alphas, betas, out_lens, ll, gvec)
    stream = torch.cuda.current_stream().cuda_stream
    in32, out32 = in_lens.int().contiguous(), out_lens.int().contiguous()
    old_alphas, old_grad = torch.empty_like(alphas), torch.empty_like(grad)

    def old_fwd():
        err = old.ctc_alpha(lp.data_ptr(), out32.data_ptr(), old_alphas.data_ptr(), B, T, L,
                            stream)
        c.check(err == 0, f"ctc_alpha (df5456f): CUDA error {err}")

    def old_bwd():
        err = old.ctc_beta_grad(lp.data_ptr(), alphas.data_ptr(), in32.data_ptr(),
                                out32.data_ptr(), ll.data_ptr(), gvec.data_ptr(),
                                old_grad.data_ptr(), B, T, L, stream)
        c.check(err == 0, f"ctc_beta_grad (df5456f): CUDA error {err}")

    old_fwd()
    old_bwd()
    torch.cuda.synchronize()
    c.check(torch.equal(old_alphas, alphas), f"({B}, {T}, {L}): the alpha rows differ")
    c.check(float((old_grad - grad).abs().max()) <= 1e-5, f"({B}, {T}, {L}): the gradients differ")
    turns = {"parent_fwd": [], "fwd": [], "parent_fwd_bwd": [], "fwd_bwd": []}
    for order in ("old", "new"), ("new", "old"):
        for who in order:
            if who == "old":
                turns["parent_fwd"].append(c.device_ms(old_fwd))
                turns["parent_fwd_bwd"].append(turns["parent_fwd"][-1] + c.device_ms(old_bwd))
            else:
                turns["fwd"].append(c.device_ms(lambda: ctc.ctc_alpha(lp, out_lens)))
                turns["fwd_bwd"].append(
                    c.device_ms(lambda: ctc.ctc_alpha_beta(lp, in_lens, out_lens))
                    + c.device_ms(lambda: ctc.ctc_grad(alphas, betas, out_lens, ll, gvec)))
    row = dict(shape=[B, T, L], **{k: statistics.mean(v) for k, v in turns.items()})
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    old = old_library(Path(sys.argv[1]).resolve())
    c.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 6)
    B, T, L = 16, 1024, 160
    in_lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=gen)
    out_lens = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=gen)
    in_lens[0], out_lens[0] = L, T
    case(old, B, T, L, in_lens, out_lens, c.SEED + 6)
    with tempfile.TemporaryDirectory() as workdir:
        workdir = Path(workdir)
        cfg = c.model_config("bfloat16")
        c.write_corpus(workdir / "corpus", cfg, np.random.default_rng(c.SEED + 7))
        cfg["preprocessing"]["save_dir"] = "corpus"
        cfg["training"].update(batch_size=16, training_filelist="corpus/training_filelist.psv",
                               validation_filelist="corpus/validation_filelist.psv")
        (workdir / "config.json").write_text(json.dumps(cfg))
        for T, mel_lens, L, text_lens in c._bucket_lengths(workdir):
            case(old, len(mel_lens), T, L, text_lens, mel_lens, c.SEED + 10 + T)


if __name__ == "__main__":
    main()
