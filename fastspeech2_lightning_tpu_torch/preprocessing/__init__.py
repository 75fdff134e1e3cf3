"""Spectral features, audio in and out, and the text side of preprocessing
(the parts of the JAX package's ``preprocessing`` that synthesis and the
trainer's data need)."""
