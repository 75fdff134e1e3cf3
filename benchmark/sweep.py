"""The serving cell's load sweep, made once to find the knee: the highest
offered rate whose completed rate keeps up with no growing backlog.

    python benchmark/sweep.py --workload <serving cell> --seed <n> --seconds <s> --rates 10 20 30

runs the cell once a rate in one process and prints a JSON line a rate:
the offered and completed rates, the median and 95th-percentile latency,
the latency of the window's last third over its first third (a backlog
that grows shows as a ratio well above 1) and the generator's lateness."""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.common import harness

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    driver = harness.load_module("traffic", cell.traffic)
    import shutil
    import tempfile

    for rate in args.rates:
        cell.params = dict(cell.params, rate=rate)
        workdir = Path(tempfile.mkdtemp(prefix="fs2sweep-"))
        try:
            out = driver.run(harness.Run(cell, args.seed, args.seconds, False,
                                         torch.device("cuda", 0), time.perf_counter(), workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        lat = out.readings.spans["request_ms"]
        n = len(lat)
        third = max(1, n // 3)
        first, last = lat[:third], lat[-third:]
        ok = [x for x in lat if math.isfinite(x)]
        print(json.dumps({
            "rate": rate, "requests": n, "failed": out.failed,
            "completed_per_s": len(ok) / out.readings.window_s,
            "p50_ms": statistics.median(lat) if n else None,
            "p95_ms": out.end_to_end["serve_p95_ms"],
            "last_over_first_third": (statistics.median(last) / statistics.median(first)
                                      if all(map(math.isfinite, first + last)) else None),
            "late_ms_p95": sorted(out.readings.spans["late_ms"])[int(0.95 * (n - 1))],
            "occupancy": (out.readings.counters["rows_occupied"]
                          / max(out.readings.counters["rows_dispatched"], 1)),
            "correct": all(c.ok for c in out.checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
