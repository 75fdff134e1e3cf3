"""The default shapes' kernel times of two trees on one card, in turns.

Times A alone at ``EXTRA_FWD``'s shapes (dh 256 and 768, the dh-384
serving batch, and dh 128 at the default model's training and serving
batches) and B and C's three entries alone at ``EXTRA_CHAINS``' (texts of
4096 and 8191 symbols), first, so that every tree reaches them in the same
state, then runs ``chip_smoke.py``'s phases 3 (A
at serving shapes), 7-8 (A and A' at the training shapes), 9 (MAS), 10
(CTC), phase 32's attention part (A and A' at dh 192) and phase 33's (A and
A' at dh 257-768, timed at dh 384 and 512 and A at the dh-384 serving
shape; B and C at texts of 1024-8191 symbols, timed at (16, 2048, 2000)),
from each tree given, one process a tree, in the order given
(parent, change, change, parent), and prints every device time logged, one
row a timed line, each tree's runs beside the others and the change's mean
over the parent's, and the seconds each phase took. A tree
is a checkout's root; an older one is unpacked where ``.gitignore`` keeps it
out of the commit:

    git archive <parent> | tar -x -C _archive/parent
    python tools/default_shapes_ab.py _archive/parent . . _archive/parent

Each tree builds its own kernels into its own ``_build/``. ``--json PATH``
writes the rows as JSON too, with every run's log lines (wall ms, bounds,
errors)."""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

# (B, H, T, dh, p): A alone, bf16, on ragged key masks (chip_smoke._ragged_bias);
# the dh-384 serving shape too, which an older tree's phase 33 may not time
EXTRA_FWD = ((16, 2, 2048, 256, 0.2), (16, 1, 1024, 768, 0.2), (8, 1, 1024, 384, 0.0),
             (16, 2, 1024, 128, 0.2), (8, 2, 1024, 128, 0.0))
# (B, T, L): B and C alone (no plain version), lengths drawn from [L/4, L]
# and [T/2, T], item 0 full; at (16, 2048, 8191) the inputs of
# chip_smoke._chains_alone, drawn alike (inline below: an older tree lacks it)
EXTRA_CHAINS = ((16, 2048, 4096), (16, 2048, 8191))

RUN = r"""
import json, math, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from fastspeech2_lightning_tpu_torch.ops.attention import attention_fwd
lines = []
real_log = c.log
def log(msg):
    lines.append(msg)
    real_log(msg)
c.log = log
smi = c.phase_device()
c.phase_build()
lines.clear()
for B, H, T, dh, p in json.loads(sys.argv[1]):
    g = torch.Generator(device="cuda").manual_seed(1000 + dh + T)
    bias, needed = c._ragged_bias(B, T, g)
    q, k, v = (torch.randn(B, H, T, dh, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    seed = torch.tensor([3217], dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(dh)
    ms = c.device_ms(lambda: attention_fwd(q, k, v, bias, scale, p=p, seed=seed,
                                           with_lse=p > 0))
    bound = c.bound_ms(4.0 * float(needed.sum()) * H * T * dh,
                       4 * B * H * T * dh * 2 + B * T * 4, "bfloat16")
    log(f"A alone {B, H, T, dh} p={p}: device {ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]})")
    del q, k, v
    torch.cuda.empty_cache()
from fastspeech2_lightning_tpu_torch.ops import ctc
from fastspeech2_lightning_tpu_torch.ops.mas import mas_width1
for B, T, L in json.loads(sys.argv[2]):
    g = torch.Generator(device="cuda").manual_seed(2000 + L)
    in_lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
    out_lens = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g)
    in_lens[0], out_lens[0] = L, T
    la = torch.log_softmax(torch.randn(B, T, L, device="cuda", generator=g), -1)
    log(f"B alone {B, T, L}: device {c.device_ms(lambda: mas_width1(la, in_lens, out_lens)):.4f}")
    del la
    logits = torch.cat([torch.full((B, T, 1), -1.0, device="cuda"),
                        torch.randn(B, T, L, device="cuda", generator=g)], -1)
    lp = torch.log_softmax(torch.where(torch.arange(L + 1, device="cuda")
                                       > in_lens[:, None, None], ctc.NEG_INF, logits), -1)
    del logits
    gvec = torch.rand(B, device="cuda", generator=g)
    alphas, betas = ctc.ctc_alpha_beta(lp, in_lens, out_lens)
    ll = ctc._final_ll(alphas[:, -1], in_lens)
    for name, fn in (("ctc_alpha", lambda: ctc.ctc_alpha(lp, out_lens)),
                     ("ctc_alpha_beta", lambda: ctc.ctc_alpha_beta(lp, in_lens, out_lens)),
                     ("ctc_grad", lambda: ctc.ctc_grad(alphas, betas, out_lens, ll, gvec))):
        log(f"C {name} alone {B, T, L}: device {c.device_ms(fn, iters=5):.4f}")
    del lp, alphas, betas
    torch.cuda.empty_cache()
seconds = {}
for fn in (c.phase_attention, c.phase_attention_train, c.phase_mas, c.phase_ctc,
           c._wide_attention, c._long_attention, c._long_mas, c._long_ctc):
    t0 = time.perf_counter()
    fn()
    seconds[fn.__name__] = round(time.perf_counter() - t0, 1)
print("AB_LINES " + json.dumps({"card": smi, "lines": lines, "seconds": seconds}), flush=True)
"""


def device_times(line: str) -> list:
    """Every device figure of a log line: 'device X' and phase 7-8's
    'device ms: A X, A' Y, ...' list."""
    if "device ms:" in line:
        tail = line.split("device ms:", 1)[1]
        return [float(x) for x in re.findall(r"(?<![\w.])([0-9]+\.[0-9]+)", tail)]
    return [float(x) for x in re.findall(r"device ([0-9]+\.[0-9]+)", line)]


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(EXTRA_FWD),
                           json.dumps(EXTRA_CHAINS)], cwd=tree, env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        sys.exit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("AB_LINES "))
    return json.loads(line[len("AB_LINES "):])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--json", type=Path, help="also write the rows here")
    args = parser.parse_args()
    runs, logs = [], []
    for tree in args.trees:
        out = run_tree(tree.resolve())
        print(f"{tree}: {out['card']}; seconds a step {out['seconds']}", flush=True)
        logs.append(dict(tree=str(tree), card=out["card"], seconds=out["seconds"],
                         lines=out["lines"]))
        # a line's name: its text before the first colon, figures masked, with
        # its occurrence among lines of that name (a tree may log a line the
        # other lacks, so rows are matched by name, not by position)
        timed, seen = {}, {}
        for x in out["lines"]:
            figures = device_times(x)
            if not figures:
                continue
            name = re.sub(r"\d+\.\d+", "#", x.split(":")[0])
            seen[name] = seen.get(name, 0) + 1
            timed[name if seen[name] == 1 else f"{name} ({seen[name]})"] = figures
        runs.append((str(tree), timed))
    names = list(dict.fromkeys(n for _, timed in runs for n in timed))
    parent = {str(args.trees[0])}
    rows = []
    for name in names:
        figures = {}
        for tree, timed in runs:
            if name in timed:
                figures.setdefault(tree, []).append(timed[name])
        by_tree = {t: [statistics.mean(col) for col in zip(*fs)] for t, fs in figures.items()}
        base = [v for t, v in by_tree.items() if t in parent]
        other = [v for t, v in by_tree.items() if t not in parent]
        ratio = ([o / b for o, b in zip(other[0], base[0])] if base and other else [])
        rows.append(dict(line=name, runs=figures, ratio=ratio))
        print(f"{name}: " + "; ".join(f"{t} {fs}" for t, fs in figures.items())
              + f"; change / parent {[round(r, 4) for r in ratio]}", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(rows=rows, runs=logs), indent=1))


if __name__ == "__main__":
    main()
