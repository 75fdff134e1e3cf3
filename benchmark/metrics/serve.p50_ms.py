"""The median request's time from its due time to the last byte of its
body, over every request due in the window (the load generator's spans; a
failed request counts as infinite)."""

import math

UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p95_ms"


def read(r):
    xs = sorted(r.spans.get("request_ms") or [])
    if not xs:
        return None
    v = xs[(len(xs) + 1) // 2 - 1]
    return v if math.isfinite(v) else None
