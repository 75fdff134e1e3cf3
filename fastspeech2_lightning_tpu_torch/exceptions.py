"""Typed exceptions (a copy of the JAX package's ``exceptions.py``, the
everyvoice.exceptions surface the reference uses)."""


class BadDataError(Exception):
    """Raised when data fails validation (e.g., precomputed durations that do
    not sum to the mel length — fs2/variance_adaptor.py:289-305)."""


class InvalidConfiguration(Exception):
    """Raised for configuration combinations that cannot work (e.g.,
    learn_alignment=False without precomputed durations — fs2/dataset.py:149)."""


class TrainingDivergedError(Exception):
    """Raised by the training loop when a fetched loss is non-finite and
    training.halt_on_non_finite is set: an Adam step through a NaN gradient
    poisons the moments permanently, so continuing would burn the rest of the
    run producing garbage checkpoints."""
