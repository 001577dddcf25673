from muygpys_torch.gp.hyperparameter.scalar import Parameter, VectorParameter
from muygpys_torch.gp.hyperparameter.scale import (
    AnalyticScale,
    FixedScale,
    ScaleFn,
)

__all__ = [
    "AnalyticScale",
    "FixedScale",
    "Parameter",
    "ScaleFn",
    "VectorParameter",
]
