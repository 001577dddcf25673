from muygpys_torch.gp.noise.heteroscedastic import HeteroscedasticNoise
from muygpys_torch.gp.noise.homoscedastic import HomoscedasticNoise

__all__ = ["HeteroscedasticNoise", "HomoscedasticNoise"]
