"""nvcc build and ctypes loading of the CUDA sources under ``csrc/``."""
