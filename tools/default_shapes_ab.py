"""The default shapes' kernel times of two trees on one card, in turns.

Runs ``chip_smoke.py``'s phases 3 (A at serving shapes), 7-8 (A and A' at
the training shapes), 9 (MAS), 10 (CTC), phase 32's attention part (A and
A' at dh 192) and phase 33's (A and A' at dh 257-768, timed at dh 384 and
512) from each tree given, one process a tree, in the order given
(parent, change, change, parent), and prints every device time those phases
log, one row a timed line, each tree's runs beside the others and the
change's mean over the parent's. A tree is a checkout's root; an older one
is unpacked where ``.gitignore`` keeps it out of the commit:

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

RUN = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke as c
lines = []
real_log = c.log
def log(msg):
    lines.append(msg)
    real_log(msg)
c.log = log
smi = c.phase_device()
c.phase_build()
lines.clear()
c.phase_attention()
c.phase_attention_train()
c.phase_mas()
c.phase_ctc()
c._wide_attention()
c._long_attention()
print("AB_LINES " + json.dumps({"card": smi, "lines": lines}), flush=True)
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
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env, capture_output=True,
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
        print(f"{tree}: {out['card']}", flush=True)
        logs.append(dict(tree=str(tree), card=out["card"], lines=out["lines"]))
        # a line's name: its text before the first colon, figures masked
        timed = [(re.sub(r"\d+\.\d+", "#", x.split(":")[0]), device_times(x))
                 for x in out["lines"]]
        runs.append((str(tree), [t for t in timed if t[1]]))
    names = [name for name, _ in runs[0][1]]
    parent = {str(args.trees[0])}
    rows = []
    for i, name in enumerate(names):
        figures = {}
        for tree, timed in runs:
            if i < len(timed) and timed[i][0] == name:
                figures.setdefault(tree, []).append(timed[i][1])
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
