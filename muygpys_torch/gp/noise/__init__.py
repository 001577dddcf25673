from muygpys_torch.gp.noise.heteroscedastic import HeteroscedasticNoise
from muygpys_torch.gp.noise.homoscedastic import HomoscedasticNoise
from muygpys_torch.gp.noise.shear import ShearNoise33

__all__ = ["HeteroscedasticNoise", "HomoscedasticNoise", "ShearNoise33"]
