"""Tensor ops of the serving path; ``attention`` and ``vocoder_resblocks``
hold the wrappers of the CUDA kernels."""
