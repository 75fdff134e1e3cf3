"""The served model's share of the card's peaks over the window (``common.readers.served_mfu``)."""

from benchmark.common import readers

UNIT = "%"
SOURCE = "host_clock"
MOVES = "synth_audio_s_per_s"
read = readers.served_mfu
