from muygpys_torch.nn.muygps_layer import (
    DeepKernelMuyGPs,
    MultivariateMuyGPsLayer,
    MuyGPsLayer,
)

__all__ = ["DeepKernelMuyGPs", "MultivariateMuyGPsLayer", "MuyGPsLayer"]
