"""The micro-batcher's share of dispatched rows that carried a request:
``GET /stats`` ``rows_occupied`` over ``rows_dispatched``, both read as
differences across the window."""

UNIT = "share"
SOURCE = "program_counter"
MOVES = "serve_p95_ms"


def read(r):
    n = r.counters.get("rows_dispatched")
    return r.counters["rows_occupied"] / n if n else None
