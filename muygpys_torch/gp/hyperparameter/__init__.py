from muygpys_torch.gp.hyperparameter.scalar import (
    NamedParameter,
    NamedVectorParameter,
    Parameter,
    VectorParameter,
)
from muygpys_torch.gp.hyperparameter.scale import (
    AnalyticScale,
    FixedScale,
    ScaleFn,
)

__all__ = [
    "AnalyticScale",
    "FixedScale",
    "NamedParameter",
    "NamedVectorParameter",
    "Parameter",
    "ScaleFn",
    "VectorParameter",
]
