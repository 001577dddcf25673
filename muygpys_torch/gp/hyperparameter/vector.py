"""Vector hyperparameters (e.g. anisotropic per-feature length scales).

Counterpart of :mod:`muygpys_tpu.gp.hyperparameter.vector`; the classes live
in :mod:`muygpys_torch.gp.hyperparameter.scalar` beside the named scalar
parameter they are built from.
"""

from muygpys_torch.gp.hyperparameter.scalar import (
    NamedVectorParameter,
    VectorParameter,
)

__all__ = ["NamedVectorParameter", "VectorParameter"]
