"""Steps a trainer call, the mean of the window's ``train_log.jsonl``
``call_steps``: ``training.steps_per_call`` when every call replays the
captured step."""

UNIT = "count"
SOURCE = "program_counter"
MOVES = "train_frames_per_s"


def read(r):
    rows = r.records.get("log_rows")
    if not rows:
        return None
    return sum(row["call_steps"] for row in rows) / len(rows)
