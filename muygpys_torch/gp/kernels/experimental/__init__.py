from muygpys_torch.gp.kernels.experimental.shear import (
    ShearKernel,
    ShearKernel2in3out,
)

__all__ = ["ShearKernel", "ShearKernel2in3out"]
