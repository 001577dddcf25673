from muygpys_torch.gp.noise.heteroscedastic import HeteroscedasticNoise
from muygpys_torch.gp.noise.homoscedastic import HomoscedasticNoise
from muygpys_torch.gp.noise.noise_fn import NoiseFn
from muygpys_torch.gp.noise.null import NullNoise
from muygpys_torch.gp.noise.shear import ShearNoise33

__all__ = [
    "HeteroscedasticNoise",
    "HomoscedasticNoise",
    "NoiseFn",
    "NullNoise",
    "ShearNoise33",
]
