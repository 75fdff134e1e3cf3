"""The process's peak of allocated device memory, GiB (``common.readers.memory_peak_gib``)."""

from benchmark.common import readers

UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "vocoder_train_samples_per_s"
read = readers.memory_peak_gib
