"""The harness: finds a cell's files by name, runs its traffic driver, reads
its per-layer metrics and prints the result line.

A traffic driver (``benchmark/traffic/<name>.py``) has ``run(run: Run) ->
Outcome``: it sets up, warms up every shape its traffic uses, measures for
``run.seconds`` (tracing the device for part of the window when
``run.trace``), reads the memory peak, frees the program's state and checks
what the timed path produced against the plain reference. A per-layer
metric (``benchmark/metrics/<name>.py``) has ``UNIT``, ``SOURCE``,
``MOVES`` and ``read(readings) -> float | None``; None leaves the metric out
of the line. No name of a cell, driver or metric is written here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: str
    params: dict
    chips: int
    end_to_end: Dict[str, str]  # name -> unit
    per_layer: List[str]


def _json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf8"))


def load_cell(name: str) -> Cell:
    wl = _json(BENCH / "workloads" / f"{name}.json")
    return Cell(name=name, config_name=wl["config"],
                config=_json(BENCH / "configs" / f"{wl['config']}.json"),
                traffic=wl["traffic"], params=wl["params"], chips=int(wl["chips"]),
                end_to_end=dict(wl["end_to_end"]), per_layer=list(wl["per_layer"]))


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Check:
    """One number compared for ``correct``: it passes when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Readings:
    """What a per-layer metric reads: the window on the host's clock, the
    spans and counters the traffic driver recorded around the program's layers, and
    the device trace of part of the window."""
    window_s: float
    config: dict
    params: dict
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    records: Dict[str, list] = dataclasses.field(default_factory=dict)
    trace: Any = None  # common.trace.DeviceTrace


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    readings: Readings
    memory_peak_bytes: int


@dataclasses.dataclass
class Run:
    """What a driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float
    workdir: Path
    fault: Optional[str] = None  # a planted fault, for the harness's own tests

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.params

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_process


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
             fault: Optional[str] = None) -> dict:
    """Run the cell once; returns the result dict that ``emit`` prints."""
    import torch

    torch.set_num_threads(4)
    driver = load_module("traffic", cell.traffic)
    workdir = Path(tempfile.mkdtemp(prefix="fs2bench-"))
    try:
        out: Outcome = driver.run(Run(cell, seed, seconds, trace, device, t_process, workdir,
                                      fault))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if trace:
        metrics = {}
        for name in cell.per_layer:
            mod = load_module("metrics", name)
            value = mod.read(out.readings)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
    else:
        metrics = {name: {"value": float(out.end_to_end[name]), "unit": unit}
                   for name, unit in cell.end_to_end.items()}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device_info}
    tr = out.readings.trace
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
