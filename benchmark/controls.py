"""The controls of ``correct``: the plain reference put in the program's
place, computed in a lower precision, checked against itself in float32 as
a run checks the program.

    python benchmark/controls.py --workload <cell> --mode <fp8|bfloat16|tf32> --seeds 1 2 3

prints one JSON line a seed with each number compared and its limit. It
runs on the card where there is one (at the cell's own size) and needs no
window; the harness's tests run it on the CPU at a small size."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.common import harness

    cell = harness.load_cell(args.workload)
    driver = harness.load_module("traffic", cell.traffic)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        workdir = Path(tempfile.mkdtemp(prefix="fs2control-"))
        try:
            run = harness.Run(cell, seed, 0.0, False, device, time.perf_counter(), workdir)
            checks = driver.control(run, args.mode)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
