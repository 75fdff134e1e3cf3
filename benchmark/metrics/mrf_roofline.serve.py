"""The MRF kernels' share of their bound in the traced vocoder calls
(``common.readers.mrf_roofline``)."""

from benchmark.common import readers

UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_p95_ms"
read = readers.mrf_roofline
