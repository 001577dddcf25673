from muygpys_torch.gp.deformation.anisotropy import Anisotropy
from muygpys_torch.gp.deformation.deformation_fn import DeformationFn
from muygpys_torch.gp.deformation.isotropy import DifferenceIsotropy, Isotropy
from muygpys_torch.gp.deformation.metric import F2, MetricFn, l2
from muygpys_torch.gp.deformation.null import NullDeformation

__all__ = [
    "Anisotropy",
    "DeformationFn",
    "DifferenceIsotropy",
    "F2",
    "Isotropy",
    "l2",
    "MetricFn",
    "NullDeformation",
]
