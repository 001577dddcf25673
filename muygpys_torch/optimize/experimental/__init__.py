from muygpys_torch.optimize.experimental.chassis import (
    optimize_from_tensors_mini_batch,
)

__all__ = ["optimize_from_tensors_mini_batch"]
