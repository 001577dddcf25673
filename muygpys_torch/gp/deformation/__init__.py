from muygpys_torch.gp.deformation.anisotropy import Anisotropy
from muygpys_torch.gp.deformation.isotropy import DifferenceIsotropy, Isotropy
from muygpys_torch.gp.deformation.metric import F2, MetricFn, l2

__all__ = [
    "Anisotropy", "DifferenceIsotropy", "F2", "Isotropy", "l2", "MetricFn",
]
