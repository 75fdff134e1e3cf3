"""Preemption-safe training shutdown (a copy of the JAX package's
``training/preemption.py``).

Clouds reclaim preemptible VMs by delivering SIGTERM with a short grace
window. The trainer responds by finishing the step in flight, writing a
checkpoint at that step, and returning normally, so the CLI exits 0 and a
restart resumes at the same step."""

from __future__ import annotations

import signal
from typing import Dict


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGINT)) -> Dict[str, object]:
    """Arm a one-shot graceful-shutdown flag for `signals`.

    Returns a dict the training loop polls: {"flag": bool, "signum": int,
    "disarm": callable}. The first signal sets the flag and restores the
    original handlers at once, so a second signal behaves normally; a loop
    that finishes without being signalled calls `disarm()` (in a finally)
    so sequential fits never stack handlers. Off the main thread signal
    handlers cannot be installed: the flag is returned unarmed."""
    state: Dict[str, object] = {"flag": False, "signum": None}
    originals = {}

    def _restore():
        for s, h in list(originals.items()):
            try:
                signal.signal(s, h)
            except (ValueError, OSError):  # pragma: no cover - teardown race
                pass
        originals.clear()

    def _on_signal(signum, _frame):
        state["flag"] = True
        state["signum"] = signum
        _restore()

    state["disarm"] = _restore
    try:
        for s in signals:
            originals[s] = signal.signal(s, _on_signal)
    except ValueError:
        # not the main thread; leave handlers untouched
        _restore()
    return state
