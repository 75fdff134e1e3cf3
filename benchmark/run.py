"""Run one cell of the benchmark once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's file ``benchmark/workloads/<cell>.json``
names its configuration (``benchmark/configs/<config>.json``), its traffic
driver (``benchmark/traffic/<driver>.py``) and that driver's parameters, and
its metrics: with ``--trace 0`` the end-to-end ones, which the traffic driver measures
on the host's clock, with ``--trace 1`` the per-layer ones, each read by
``benchmark/metrics/<metric>.py`` from the run's spans, counters and device
trace. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: every number compared for ``correct``
beside its limit); the checks are also the last lines of standard error.

The run needs CUDA and as many cards as the cell asks for: without them it
exits with code 3 and prints no result. It exits with code 4, and no
result, when JAX, flax or the JAX package was loaded. Build and kernel
caches stay under ``.bench_cache/`` in the checkout."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fastspeech2_lightning_tpu")


def cache_env(root: Path) -> dict:
    """Fixed cache directories inside the checkout, and no JAX behind a
    library's back."""
    cache = root / ".bench_cache"
    return {"TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
            "PYTORCH_KERNEL_CACHE_PATH": str(cache / "kernels"),
            "CUDA_CACHE_PATH": str(cache / "cuda"),
            "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    env = cache_env(ROOT)
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "TORCHINDUCTOR_CACHE_DIR",
                "PYTORCH_KERNEL_CACHE_PATH", "CUDA_CACHE_PATH"):
        Path(env[key]).mkdir(parents=True, exist_ok=True)
    os.environ.update(env)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
    from benchmark.common import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr, flush=True)
        return 3
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device=torch.device("cuda", 0),
                              t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}", file=sys.stderr, flush=True)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
