from muygpys_torch.gp.muygps import MuyGPS

__all__ = ["MuyGPS"]
