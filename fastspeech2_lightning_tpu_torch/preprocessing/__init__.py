"""Corpus preprocessing (counterpart of the JAX package's
``preprocessing``): the ``Preprocessor`` pipeline and its pieces (spectral
features, pitch, priors, statistics, sox effects), the reference-tree
converter and the objective audio metrics."""
