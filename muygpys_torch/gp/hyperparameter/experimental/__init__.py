from muygpys_torch.gp.hyperparameter.experimental.hierarchical import (
    HierarchicalParameter,
    NamedHierarchicalParameter,
    NamedHierarchicalVectorParameter,
    sample_knots,
)

__all__ = [
    "HierarchicalParameter",
    "NamedHierarchicalParameter",
    "NamedHierarchicalVectorParameter",
    "sample_knots",
]
