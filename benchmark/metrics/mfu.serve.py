"""The served model's share of the card's peaks over the window (``common.readers.served_mfu``)."""

from benchmark.common import readers

UNIT = "%"
SOURCE = "host_clock"
MOVES = "serve_p95_ms"
read = readers.served_mfu
