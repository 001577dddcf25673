"""LOO training: batch sampling, objectives, losses and the chassis.

Counterpart of :mod:`muygpys_tpu.optimize`: the Bayesian, L-BFGS-B, Adam
and fused chassis, the device chassis
(:mod:`muygpys_torch.optimize.device_chassis`: whole L-BFGS trajectories
replayed as CUDA graphs), and the mini-batch loop of
:mod:`muygpys_torch.optimize.experimental`.
"""

from muygpys_torch.optimize.batch import (
    full_filtered_batch,
    get_balanced_batch,
    sample_balanced_batch,
    sample_batch,
)
from muygpys_torch.optimize.chassis import (
    Adam_optimize,
    Bayes_optimize,
    L_BFGS_B_optimize,
    OptimizeFn,
)
from muygpys_torch.optimize.device_chassis import (
    Device_LBFGS_optimize,
    Fused_Device_LBFGS_optimize,
    device_lbfgs,
    make_device_trainer,
)
from muygpys_torch.optimize.fast_objective import (
    fast_objective_supports,
    make_fast_loo_objective,
)
from muygpys_torch.optimize.fused_chassis import Fused_L_BFGS_B_optimize
from muygpys_torch.optimize.loss import (
    LossFn,
    cross_entropy_fn,
    lool_fn,
    lool_fn_unscaled,
    looph_fn,
    mse_fn,
    pseudo_huber_fn,
)
from muygpys_torch.optimize.objective import make_loo_crossval_fn
from muygpys_torch.optimize.shear_objective import (
    make_shear_loo_objective,
    shear_objective_supports,
)

__all__ = [
    "Adam_optimize",
    "Bayes_optimize",
    "Device_LBFGS_optimize",
    "Fused_Device_LBFGS_optimize",
    "Fused_L_BFGS_B_optimize",
    "L_BFGS_B_optimize",
    "LossFn",
    "OptimizeFn",
    "cross_entropy_fn",
    "device_lbfgs",
    "fast_objective_supports",
    "full_filtered_batch",
    "get_balanced_batch",
    "lool_fn",
    "lool_fn_unscaled",
    "looph_fn",
    "make_device_trainer",
    "make_fast_loo_objective",
    "make_loo_crossval_fn",
    "make_shear_loo_objective",
    "mse_fn",
    "pseudo_huber_fn",
    "sample_balanced_batch",
    "sample_batch",
    "shear_objective_supports",
]
