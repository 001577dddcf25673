"""LOO cross-validation objective assembly.

Counterpart of :mod:`muygpys_tpu.optimize.objective`: a function of named
free hyperparameters closing over fixed tensors, differentiable by
``torch.autograd`` when the values passed are tensors that require grad.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from muygpys_torch.optimize.loss import LossFn


def make_kernels_fn(kernel_fn: Callable, pairwise_diffs, crosswise_diffs):
    def kernels_fn(*args, **kwargs):
        Kin = kernel_fn(pairwise_diffs, *args, **kwargs)
        Kcross = kernel_fn(crosswise_diffs, *args, **kwargs)
        return Kin, Kcross

    return kernels_fn


def make_loo_crossval_fn(
    loss_fn: LossFn,
    kernel_fn: Callable,
    mean_fn: Callable,
    var_fn: Callable,
    scale_fn: Callable,
    pairwise_diffs,
    crosswise_diffs,
    batch_nn_targets,
    batch_targets,
    batch_features=None,
    target_mask=None,
    loss_kwargs: Optional[Dict] = None,
) -> Callable:
    """Assemble ``obj_fn(**free_params) -> -loss`` over a fixed batch;
    ``batch_features`` goes to every kernel evaluation (a hierarchical
    length scale reads it) unless the caller passes its own."""
    kernels_fn = make_kernels_fn(kernel_fn, pairwise_diffs, crosswise_diffs)
    predict_and_loss_fn = loss_fn.make_predict_and_loss_fn(
        mean_fn,
        var_fn,
        scale_fn,
        batch_nn_targets,
        batch_targets,
        target_mask=target_mask,
        **(loss_kwargs or {}),
    )

    def obj_fn(*args, **kwargs):
        if batch_features is not None:
            kwargs.setdefault("batch_features", batch_features)
        Kin, Kcross = kernels_fn(*args, **kwargs)
        return predict_and_loss_fn(Kin, Kcross, *args, **kwargs)

    return obj_fn
