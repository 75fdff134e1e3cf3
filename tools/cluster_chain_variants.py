"""Kernels B and C past the rings' reach against variants of themselves.

Builds ``csrc/ctc_banded_lse.cu`` and ``csrc/mas_width1.cu`` again with -D
macros that the sources define (their defaults are the kernels' own
choices), through ``kernels.build`` (all variants' nvcc started together),
puts each variant under the wrappers in turn (``build.using``), and times
them as device ms (``chip_smoke.device_ms``) in turns (the source, each
variant, the variants again in reverse, the source):

- C, ``ctc_alpha`` and ``ctc_alpha_beta`` at (16, 2048, 2000): the cluster
  size forced to 2, 3, 4, 6 or 8 blocks a chain (``FS2T_CTC_BLOCKS``, in
  place of ``slice_layout``'s choice); one or two copy warps a block
  instead of four (``FS2T_CTC_COPY_WARPS``); a second block allowed on an
  SM (``FS2T_CTC_SM_ALONE_KB=0``); at most 19 chain warps a block instead
  of 27 (``FS2T_CTC_SLICE_WARPS``). At (16, 2048, 8191) the source's choice
  against 8 blocks a chain and against at most 19 warps a block (more
  waves of narrower slices). Rows bit-equal to the source's.
- B at (16, 2048, 1000): the ring kernel against the cluster kernel at one
  block a cluster (``FS2T_MAS_RING_L=512``), and that kernel with its copy
  warps copying nothing (``FS2T_MAS_STAGE=0``; timing only: the path is
  then wrong); at (16, 2048, 2000) the cluster kernel with the Spread and
  LoadBalancing cluster scheduling policies (``FS2T_CLUSTER_POLICY``).

    python tools/cluster_chain_variants.py [--json PATH]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

# (B, T, L) and the C variants timed there (None: all)
C_SHAPES = (((16, 2048, 2000), None), ((16, 2048, 8191), ("ctc_blocks8", "ctc_warps19")))
B_SHAPES = {"ring": (16, 2048, 1000), "cluster": (16, 2048, 2000)}
# variant -> the -D macros it is built with
CTC_VARIANTS = {
    **{f"ctc_blocks{c}": (f"-DFS2T_CTC_BLOCKS={c}",) for c in (2, 3, 4, 6, 8)},
    "ctc_copy1": ("-DFS2T_CTC_COPY_WARPS=1",),
    "ctc_copy2": ("-DFS2T_CTC_COPY_WARPS=2",),
    "ctc_shared_sm": ("-DFS2T_CTC_SM_ALONE_KB=0",),
    "ctc_warps19": ("-DFS2T_CTC_SLICE_WARPS=19",),
}
MAS_VARIANTS = {
    "mas_one_block_cluster": ("-DFS2T_MAS_RING_L=512",),
    "mas_one_block_cluster_no_copies": ("-DFS2T_MAS_RING_L=512", "-DFS2T_MAS_STAGE=0"),
    "mas_spread": ("-DFS2T_CLUSTER_POLICY=1",),
    "mas_load_balancing": ("-DFS2T_CLUSTER_POLICY=2",),
}


def in_turns(names):
    return [names[0], *names[1:], *names[:0:-1], names[0]]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path, help="also write the rows here")
    args = parser.parse_args()
    smi = smoke.phase_device()
    print(smi, flush=True)

    import torch

    from fastspeech2_lightning_tpu_torch.kernels import build
    from fastspeech2_lightning_tpu_torch.ops import ctc, mas

    build.build_variants([("ctc_banded_lse", d) for d in CTC_VARIANTS.values()]
                         + [("mas_width1", d) for d in MAS_VARIANTS.values()])
    libs = {"ctc_banded_lse": build.load("ctc_banded_lse", ctc._SIGNATURES),
            "mas_width1": build.load("mas_width1", mas._ENTRIES)}
    libs.update({k: build.load("ctc_banded_lse", ctc._SIGNATURES, d)
                 for k, d in CTC_VARIANTS.items()})
    libs.update({k: build.load("mas_width1", mas._ENTRIES, d) for k, d in MAS_VARIANTS.items()})
    rows = []

    for (B, T, L), only in C_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(1)
        in_lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
        out_lens = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g)
        in_lens[0], out_lens[0] = L, T
        logits = torch.cat([torch.full((B, T, 1), -1.0, device="cuda"),
                            torch.randn(B, T, L, device="cuda", generator=g)], -1)
        lp = torch.log_softmax(torch.where(torch.arange(L + 1, device="cuda")
                                           > in_lens[:, None, None], ctc.NEG_INF, logits), -1)
        del logits
        want = ctc.ctc_alpha_beta(lp, in_lens, out_lens)
        for name in in_turns(["ctc_banded_lse", *(only or CTC_VARIANTS)]):
            with build.using("ctc_banded_lse", libs[name]):
                got = ctc.ctc_alpha_beta(lp, in_lens, out_lens)
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                del got
                alpha = smoke.device_ms(lambda: ctc.ctc_alpha(lp, out_lens), iters=10)
                both = smoke.device_ms(lambda: ctc.ctc_alpha_beta(lp, in_lens, out_lens),
                                       iters=10)
                layouts = [ctc.cluster_layout(n, L) for n in (B, 2 * B)]
            rows.append(dict(kernel="C", variant=name, shape=[B, T, L], alpha_ms=alpha,
                             alpha_beta_ms=both, rows_equal=same,
                             layouts=[f"{d['blocks']} x {d['warps']}" for d in layouts]))
            print(f"C {name} {B, T, L}: device alpha {alpha:.4f} alpha_beta {both:.4f}; "
                  f"layouts {rows[-1]['layouts']} (alpha, alpha_beta); rows equal {same}",
                  flush=True)
        del lp, want
        torch.cuda.empty_cache()

    for kind, names in (("ring", ["mas_width1", "mas_one_block_cluster",
                                  "mas_one_block_cluster_no_copies"]),
                        ("cluster", ["mas_width1", "mas_spread", "mas_load_balancing"])):
        B, T, L = B_SHAPES[kind]
        g = torch.Generator(device="cuda").manual_seed(3)
        la = torch.log_softmax(torch.randn(B, T, L, device="cuda", generator=g), -1)
        in_lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
        out_lens = torch.randint(T // 4, T + 1, (B,), device="cuda", generator=g)
        in_lens[0], out_lens[0] = L, T
        want = mas.mas_width1(la, in_lens, out_lens)
        for name in in_turns(names):
            with build.using("mas_width1", libs[name]):
                got = mas.mas_width1(la, in_lens, out_lens)
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                ms = smoke.device_ms(lambda: mas.mas_width1(la, in_lens, out_lens))
            rows.append(dict(kernel="B", variant=name, shape=[B, T, L], ms=ms, path_equal=same))
            print(f"B {name} {B, T, L}: device {ms:.4f} ({ms * 1e6 / T:.0f} ns a row); path "
                  f"equal {same}", flush=True)
        del la, want, got
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
