"""Spectral features and audio output (the parts of the JAX package's
``preprocessing`` that synthesis needs)."""
