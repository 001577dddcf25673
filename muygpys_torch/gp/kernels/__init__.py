from muygpys_torch.gp.kernels.kernel_fn import KernelFn
from muygpys_torch.gp.kernels.matern import Matern
from muygpys_torch.gp.kernels.rbf import RBF

__all__ = ["KernelFn", "Matern", "RBF"]
