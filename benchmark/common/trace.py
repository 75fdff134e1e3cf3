"""Spans and counters the benchmark records around the program's layers, and
the device trace of part of the window.

``Spans`` keeps (name -> list of durations) in memory on the host's clock,
with each span's interval while a trace runs, so the device trace can say
what the host was doing in each idle gap. ``DeviceTracer`` runs
``torch.profiler`` on the device's activity for a fixed part of the window
and, once the window has closed, reduces its events to a ``DeviceTrace``: the
kernels by name, the seconds in which some device operation ran (the union
of their intervals), the traced window's length, and the longest idle gaps
labelled by the innermost span open on the host at their middle."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "bench/"


class Spans:
    """Durations by name on the host's clock; while ``tracing``, also each
    span's (start, end) for the device trace's idle-gap labels."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.intervals: List[Tuple[float, float, str]] = []
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.spans[name].append(t1 - t0)
            if self.tracing:
                self.intervals.append((t0, t1, name))

    def mark(self, name: str, t0: float, t1: float) -> None:
        """A span that began before it could be opened (host times)."""
        self.spans[name].append(t1 - t0)
        if self.tracing:
            self.intervals.append((t0, t1, name))


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, seconds)
    gaps: List[Tuple[str, float]]  # (what the host was doing, seconds), longest first

    def seconds(self, *patterns: str) -> float:
        """Device seconds of the kernels whose name holds one of `patterns`."""
        return sum(s for name, (_, s) in self.kernels.items()
                   if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        """The ten device operations that took most time (names cut to 160
        characters) and the ten longest idle totals by host span."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        by_label: Dict[str, float] = defaultdict(float)
        for label, s in self.gaps:
            by_label[label] += s
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
                "idle_gaps": [[label, s] for label, s in gaps]}


class DeviceTracer:
    """``start()`` at the window's start; ``poll()`` in the loop stops the
    trace once `seconds` have passed; ``stop()`` ends it in any case. The
    profiler records the device's activity alone (CUDA, not the host's
    operators, whose recording would slow the host). A marker kernel launched
    at the start ties the device's clock to the host's, so the spans' host
    times label the idle gaps. The events are reduced when ``result`` is
    first read, after the window."""

    MARKER = "spin_kernel"

    def __init__(self, enabled: bool, seconds: float, spans: Optional[Spans] = None):
        self.enabled, self.seconds = enabled, seconds
        self.spans = spans if spans is not None else Spans()
        self.prof = None
        self._done = None
        self._result: Optional[DeviceTrace] = None

    def start(self) -> None:
        import torch

        if not self.enabled or not torch.cuda.is_available():
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.tracing = True
        self.t_marker = time.perf_counter()
        torch.cuda._sleep(1000)
        self.t0 = time.perf_counter()

    def poll(self) -> None:
        if self.prof is not None and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.spans.tracing = False
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self._done = (prof, t1 - self.t0)

    @property
    def result(self) -> Optional[DeviceTrace]:
        if self._result is None and self._done is not None:
            prof, window = self._done
            self._result = reduce(prof, window, self.t_marker, self.spans.intervals)
            self._done = None
        return self._result


def reduce(prof, window_s: float, t_marker: float, intervals) -> DeviceTrace:
    from torch.autograd import DeviceType

    dev = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(PREFIX):
            dev.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    marks = [a for a, _, name in dev if DeviceTracer.MARKER in name]
    origin = marks[0] if marks else (dev[0][0] if dev else 0.0)
    dev = [d for d in dev if DeviceTracer.MARKER not in d[2]]
    host = [((a - t_marker) * 1e6 + origin, (b - t_marker) * 1e6 + origin, n)
            for a, b, n in intervals]
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) / 1e6
    busy, gaps = 0.0, []
    if dev:
        lo, hi = dev[0][0], dev[0][1]
        for a, b, _ in dev[1:]:
            if a > hi:
                busy += hi - lo
                gaps.append((hi, a))
                lo, hi = a, b
            else:
                hi = max(hi, b)
        busy += hi - lo
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:500]:
        mid = (a + b) / 2
        inside = [(s, e, n) for s, e, n in host if s <= mid <= e]
        label = min(inside, key=lambda x: x[1] - x[0])[2] if inside else "outside any span"
        labelled.append((label, (b - a) / 1e6))
    return DeviceTrace(window_s=window_s, busy_s=busy / 1e6,
                       kernels={k: (int(v[0]), float(v[1])) for k, v in kernels.items()},
                       gaps=labelled)
