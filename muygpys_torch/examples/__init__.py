"""Workflows composed from the port's public API (counterparts of
:mod:`muygpys_tpu.examples`): regression, classification, two-class
uncertainty quantification, the index-based glue beneath them, and the
fast posterior mean."""

from muygpys_torch.examples import (
    classify,
    fast_posterior_mean,
    from_indices,
    regress,
    two_class_classify_uq,
)

__all__ = [
    "classify",
    "fast_posterior_mean",
    "from_indices",
    "regress",
    "two_class_classify_uq",
]
