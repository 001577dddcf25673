from muygpys_torch.gp.hyperparameter.scalar import (
    NamedParameter,
    Parameter,
    ScalarParam,
)
from muygpys_torch.gp.hyperparameter.vector import (
    NamedVectorParameter,
    VectorParameter,
)
from muygpys_torch.gp.hyperparameter.tensor import TensorParam
from muygpys_torch.gp.hyperparameter.scale import (
    AnalyticScale,
    DownSampleScale,
    FixedScale,
    ScaleFn,
)

__all__ = [
    "AnalyticScale",
    "DownSampleScale",
    "FixedScale",
    "NamedParameter",
    "NamedVectorParameter",
    "Parameter",
    "ScalarParam",
    "ScaleFn",
    "TensorParam",
    "VectorParameter",
]
