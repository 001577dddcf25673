from muygpys_torch.gp.multivariate_muygps import MultivariateMuyGPS
from muygpys_torch.gp.muygps import MuyGPS

__all__ = ["MultivariateMuyGPS", "MuyGPS"]
