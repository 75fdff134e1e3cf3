"""The trainer's wait for its next call's batches, ms a call: the window's
``train_log.jsonl`` ``wait_ms`` (a call's wait shared over its steps)
summed, over the window's calls."""

UNIT = "ms"
SOURCE = "program_counter"
MOVES = "train_frames_per_s"


def read(r):
    rows = r.records.get("log_rows")
    if not rows or not r.counters.get("calls"):
        return None
    return sum(row["wait_ms"] for row in rows) / r.counters["calls"]
