"""Loss functors pairing raw losses with prediction strategies.

Counterpart of :mod:`muygpys_tpu.optimize.loss`: ``LossFn`` with the
mean-only (``make_raw_predict_and_loss_fn``) and mean + variance + scale
(``make_var_predict_and_loss_fn``) strategies; objectives return ``-loss``,
to be maximized.
"""

from __future__ import annotations

from typing import Callable

from muygpys_torch.ops import loss as _l


def make_raw_predict_and_loss_fn(
    loss_fn: Callable,
    mean_fn: Callable,
    var_fn: Callable,
    scale_fn: Callable,
    batch_nn_targets,
    batch_targets,
    target_mask=None,
    **loss_kwargs,
) -> Callable:
    """Mean-only strategy: score the posterior mean against targets."""

    def predict_and_loss_fn(Kin, Kcross, *args, **kwargs):
        predictions = mean_fn(Kin, Kcross, batch_nn_targets, **kwargs)
        if target_mask is not None:
            predictions = predictions[:, target_mask]
        return -loss_fn(predictions, batch_targets, **loss_kwargs)

    return predict_and_loss_fn


def make_var_predict_and_loss_fn(
    loss_fn: Callable,
    mean_fn: Callable,
    var_fn: Callable,
    scale_fn: Callable,
    batch_nn_targets,
    batch_targets,
    target_mask=None,
    **loss_kwargs,
) -> Callable:
    """Mean + variance strategy: also estimates the scale per evaluation
    (under the model's stored noise: ``scale_fn`` perturbs with it).  0/1
    ``row_weights`` (a ragged sharded batch) reach the scale too: they are
    its count, as in the JAX package."""
    row_weights = loss_kwargs.get("row_weights")

    def predict_and_loss_fn(Kin, Kcross, *args, **kwargs):
        predictions = mean_fn(Kin, Kcross, batch_nn_targets, **kwargs)
        scale = scale_fn(
            Kin, batch_nn_targets, row_weights=row_weights, **kwargs
        )
        variances = var_fn(Kin, Kcross, **kwargs)
        if target_mask is not None:
            predictions = predictions[:, target_mask]
            variances = variances[:, target_mask, target_mask]
        return -loss_fn(
            predictions, batch_targets, variances, scale, **loss_kwargs
        )

    return predict_and_loss_fn


class LossFn:
    """A loss function bundled with its predict-and-loss assembly strategy.

    Calling the functor evaluates the raw loss; ``make_predict_and_loss_fn``
    builds the closure used inside LOO objectives.
    """

    def __init__(self, loss_fn: Callable, make_predict_and_loss_fn: Callable):
        self._fn = loss_fn
        self._make_predict_and_loss_fn = make_predict_and_loss_fn
        self.name = getattr(loss_fn, "__name__", type(loss_fn).__name__)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def make_predict_and_loss_fn(self, *args, **kwargs) -> Callable:
        return self._make_predict_and_loss_fn(self._fn, *args, **kwargs)


cross_entropy_fn = LossFn(_l.cross_entropy_fn, make_raw_predict_and_loss_fn)
"""Cross-entropy loss for classification (mean-only)."""

mse_fn = LossFn(_l.mse_fn, make_raw_predict_and_loss_fn)
"""Mean squared error (mean-only)."""

pseudo_huber_fn = LossFn(_l.pseudo_huber_fn, make_raw_predict_and_loss_fn)
"""Robust pseudo-Huber loss (mean-only)."""

lool_fn = LossFn(_l.lool_fn, make_var_predict_and_loss_fn)
"""Leave-one-out likelihood (Eq. 10, arXiv:2209.11280; mean+var+scale)."""

lool_fn_unscaled = LossFn(
    _l.lool_fn_unscaled,
    lambda loss_fn, mean_fn, var_fn, scale_fn, nn_t, t, **kw: (
        make_var_predict_and_loss_fn(
            lambda p, tt, v, s, **lk: loss_fn(p, tt, v, **lk),
            mean_fn, var_fn, scale_fn, nn_t, t, **kw,
        )
    ),
)
"""Unscaled leave-one-out likelihood (mean+var)."""

looph_fn = LossFn(_l.looph_fn, make_var_predict_and_loss_fn)
"""Leave-one-out pseudo-Huber (Eq. 8, arXiv:2409.11577; mean+var+scale)."""
