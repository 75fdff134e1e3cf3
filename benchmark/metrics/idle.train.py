"""The share of the traced window in which no device operation ran (``common.readers.idle``)."""

from benchmark.common import readers

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_frames_per_s"
read = readers.idle
