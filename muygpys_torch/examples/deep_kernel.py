"""Deep kernel MuyGPs training and prediction.

Counterpart of :mod:`muygpys_tpu.examples.deep_kernel` (flax and optax
there): ``train_deep_kernel_muygps`` trains an embedding network and the GP
hyperparameters jointly (Adam with an exponentially decaying learning
rate, the gradient clipped to a global norm of 10, the neighbour index
rebuilt on the embedded features every ``update_frequency`` epochs);
``predict_model`` predicts through the embedded space;
``update_nearest_neighbors`` is the rebuild.

The model (:class:`muygpys_torch.nn.DeepKernelMuyGPs`) is a spec, as the
flax module is: training never changes it.  It starts from the parameters
``rng_key`` fixes (flax's ``Dense`` defaults for every ``torch.nn.Linear``:
a LeCun-normal weight, truncated at two deviations, and a zero bias; the
GP layer's values from its MuyGPS spec) and returns them as a name ->
tensor dict, which :func:`predict_model` applies with
:func:`torch.func.functional_call`.  The same ``rng_key`` gives the same
start in every call (the random stream is PyTorch's, not JAX's).

The optimizer is optax's ``chain(clip_by_global_norm(10),
adam(exponential_decay(lr, 1, decay)))`` step for step: the clip scales
the gradient by ``10 / |g|`` only when ``|g| >= 10``, then
``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8) steps at ``lr * decay^t``.
Features and responses go on ``config.device(device)`` (the card unless the
caller passes ``device="cpu"``) in ``config.ftype()``; the rebuilt index is
an ``NN_Wrapper(embedded, nn_count, **nn_kwargs)`` on that device
(``nn_kwargs={"nn_method": "pallas"}`` is the K3 candidate kernel).
"""

from __future__ import annotations

import math
from time import perf_counter
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from muygpys_torch import config
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_torch.nn.muygps_layer import MuyGPsLayer
from muygpys_torch.ops import loss as _loss

CLIP_NORM = 10.0
# flax's lecun_normal: a unit-variance normal truncated to [-2, 2] has
# standard deviation 0.87962566103423978
_TRUNCATED_STD = 0.87962566103423978


def _resolve_loss(loss_function) -> Callable:
    if callable(loss_function):
        return loss_function
    name = loss_function.lower()
    if name == "mse":
        return lambda mean, targets, var: _loss.mse_fn(mean, targets)
    if name == "l1":
        return lambda mean, targets, var: torch.sum(torch.abs(mean - targets))
    if name in ("ce", "bce"):
        return lambda mean, targets, var: _loss.cross_entropy_fn(
            mean, targets
        )
    if name == "lool":
        return lambda mean, targets, var: _loss.lool_fn_unscaled(
            mean, targets, var
        )
    raise ValueError(f"loss function {loss_function} is not supported")


def _init_params(model: torch.nn.Module, rng_key=None,
                 device=None) -> Dict[str, torch.Tensor]:
    """The parameters ``rng_key`` (an integer seed, default 0) fixes, in
    ``config.ftype()`` on ``device``: each ``torch.nn.Linear`` as flax's
    ``Dense`` initialises (in its registration order), each
    :class:`MuyGPsLayer` from its spec, any other parameter as the module
    holds it."""
    gen = torch.Generator().manual_seed(0 if rng_key is None else int(rng_key))
    dtype = config.ftype()
    params = {n: p.detach().to(dtype).clone()
              for n, p in model.named_parameters()}
    for prefix, module in model.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(module, torch.nn.Linear):
            std = math.sqrt(1.0 / module.in_features) / _TRUNCATED_STD
            weight = torch.empty(module.out_features, module.in_features,
                                 dtype=torch.float64)
            torch.nn.init.trunc_normal_(weight, std=std, a=-2.0 * std,
                                        b=2.0 * std, generator=gen)
            params[dot + "weight"] = weight.to(dtype)
            if module.bias is not None:
                params[dot + "bias"] = torch.zeros(module.out_features,
                                                   dtype=dtype)
        elif isinstance(module, MuyGPsLayer):
            for name, value in module.initial_values().items():
                params[dot + name] = value
    return {n: p.to(config.device(device)) for n, p in params.items()}


def _sub(params: Dict[str, torch.Tensor], prefix: str):
    return {n[len(prefix) + 1:]: p for n, p in params.items()
            if n.startswith(prefix + ".")}


def _embed(model, params, features):
    return functional_call(model.embedding, _sub(params, "embedding"),
                           (features,))


def _placed(a, device, dtype=None) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = np.asarray(a)
    return torch.as_tensor(a, dtype=dtype, device=device)


def update_nearest_neighbors(
    model,
    params,
    train_features,
    train_responses,
    batch_indices,
    nn_count: int,
    nn_kwargs: Optional[Dict] = None,
    device=None,
) -> Tuple[NN_Wrapper, np.ndarray, torch.Tensor]:
    """Rebuild the neighbour index on the embedded training features.

    Returns (nbrs_lookup, batch_nn_indices as numpy, their responses on the
    parameters' device)."""
    dev = next(iter(params.values())).device
    dtype = config.ftype()
    with torch.no_grad():
        embedded = _embed(model, params,
                          _placed(train_features, dev, dtype))
    kwargs = {"device": dev if device is None else device,
              **(nn_kwargs or {})}
    nbrs_lookup = NN_Wrapper(embedded.cpu().numpy(), nn_count, **kwargs)
    batch_nn_indices, _ = nbrs_lookup.get_batch_nns(np.asarray(batch_indices))
    batch_nn_indices = np.asarray(batch_nn_indices)
    batch_nn_targets = _placed(train_responses, dev, dtype)[
        torch.as_tensor(batch_nn_indices, device=dev)
    ]
    return nbrs_lookup, batch_nn_indices, batch_nn_targets


def _clip_by_global_norm(grads, max_norm: float = CLIP_NORM):
    """optax's ``clip_by_global_norm``: ``g * max_norm / |g|`` when
    ``|g| >= max_norm``, else ``g`` unchanged (no epsilon in the
    divisor)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class _Stepper:
    """One training step at a time: the parameters ``rng_key`` fixes, the
    clipped Adam with its decaying learning rate, and the objective over
    the batch; :meth:`step` takes the batch's current neighbours."""

    def __init__(self, model, train_features, train_responses,
                 batch_indices, loss_function, learning_rate,
                 scheduler_decay, rng_key, dev):
        self.model = model
        self.loss_fn = _resolve_loss(loss_function)
        self.train_features = train_features
        self.batch_idx = torch.as_tensor(np.asarray(batch_indices),
                                         device=dev)
        self.batch_responses = train_responses[self.batch_idx]
        self.params = {n: p.requires_grad_(True)
                       for n, p in _init_params(model, rng_key, dev).items()}
        self.names = list(self.params)
        self.optimizer = torch.optim.Adam(
            list(self.params.values()), lr=learning_rate,
            betas=(0.9, 0.999), eps=1e-8,
        )
        self.scheduler = torch.optim.lr_scheduler.ExponentialLR(
            self.optimizer, gamma=scheduler_decay
        )

    def step(self, nn_idx, nn_targets) -> torch.Tensor:
        """One update; returns the loss before it (on the device)."""
        mean, var = functional_call(
            self.model, self.params,
            (self.train_features, self.batch_idx, nn_idx, nn_targets),
        )
        loss = self.loss_fn(mean, self.batch_responses, var)
        grads = torch.autograd.grad(
            loss, [self.params[n] for n in self.names]
        )
        for n, g in zip(self.names, _clip_by_global_norm(grads)):
            self.params[n].grad = g
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach()


def train_deep_kernel_muygps(
    model,
    train_features,
    train_responses,
    batch_indices,
    nbrs_lookup: NN_Wrapper,
    training_iterations: int = 10,
    learning_rate: float = 1e-3,
    scheduler_decay: float = 0.95,
    loss_function="lool",
    update_frequency: int = 1,
    verbose: bool = False,
    nn_kwargs: Optional[Dict] = None,
    rng_key=None,
    device=None,
) -> Tuple[NN_Wrapper, Dict[str, torch.Tensor], dict]:
    """Train the embedding and the GP hyperparameters jointly.

    Returns (the index on the embedded space, the trained parameters as a
    name -> tensor dict, info).  ``info["final_loss"]`` is the loss of the
    last step, taken before its update (NaN for zero iterations), as in
    JAX; ``info["rebuilds"]`` and ``info["rebuild_seconds"]`` count the
    index rebuilds and their wall seconds (the device's queued steps
    finished before each is timed)."""
    dev = config.device(device)
    dtype = config.ftype()
    train_features = _placed(train_features, dev, dtype)
    train_responses = _placed(train_responses, dev, dtype)
    batch_indices = np.asarray(batch_indices)
    nn_count = nbrs_lookup.nn_count
    stepper = _Stepper(model, train_features, train_responses, batch_indices,
                       loss_function, learning_rate, scheduler_decay,
                       rng_key, dev)

    nn_np, _ = nbrs_lookup.get_batch_nns(batch_indices)
    nn_idx = torch.as_tensor(np.asarray(nn_np), device=dev)
    batch_nn_targets = train_responses[nn_idx]
    loss = torch.tensor(math.nan)
    rebuilds, rebuild_seconds = 0, 0.0
    for epoch in range(training_iterations):
        loss = stepper.step(nn_idx, batch_nn_targets)
        if verbose and epoch % 10 == 0:
            print(f"epoch {epoch}: loss={float(loss):.6g}")
        if (epoch + 1) % update_frequency == 0:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            start = perf_counter()
            nbrs_lookup, nn_np, batch_nn_targets = update_nearest_neighbors(
                model, stepper.params, train_features, train_responses,
                batch_indices, nn_count, nn_kwargs, device=dev,
            )
            nn_idx = torch.as_tensor(nn_np, device=dev)
            rebuild_seconds += perf_counter() - start
            rebuilds += 1

    trained = {n: p.detach() for n, p in stepper.params.items()}
    return nbrs_lookup, trained, {
        "final_loss": float(loss),
        "rebuilds": rebuilds,
        "rebuild_seconds": rebuild_seconds,
    }


def predict_model(
    model,
    params,
    test_features,
    train_features,
    train_responses,
    nbrs_lookup: NN_Wrapper,
    nn_count: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) of the test points through the embedded space, on
    the parameters' device.  ``nbrs_lookup`` is the index on the embedded
    training features (as :func:`train_deep_kernel_muygps` returns it)."""
    dev = next(iter(params.values())).device
    dtype = config.ftype()
    with torch.no_grad():
        embedded_test = _embed(model, params,
                               _placed(test_features, dev, dtype))
        embedded_train = _embed(model, params,
                                _placed(train_features, dev, dtype))
        test_nn_indices, _ = nbrs_lookup.get_nns(embedded_test.cpu().numpy())
        test_nn_indices = torch.as_tensor(np.asarray(test_nn_indices),
                                          device=dev)
        test_count = embedded_test.shape[0]
        train_count = embedded_train.shape[0]
        # the embedded test rows follow the training rows, so the layer's
        # crosswise indexing addresses them
        stacked = torch.cat([embedded_train, embedded_test], dim=0)
        indices = torch.arange(test_count, device=dev) + train_count
        nn_targets = _placed(train_responses, dev, dtype)[test_nn_indices]
        return functional_call(
            model.gp_layer, _sub(params, "gp_layer"),
            (stacked, indices, test_nn_indices, nn_targets),
        )


def predict_single_model(
    model, params, test_features, train_features, train_responses,
    nbrs_lookup: NN_Wrapper, nn_count: int,
):
    """The reference's ``predict_single_model``: :func:`predict_model`."""
    return predict_model(
        model, params, test_features, train_features, train_responses,
        nbrs_lookup, nn_count,
    )


def predict_multiple_model(
    model, params, test_features, train_features, train_responses,
    nbrs_lookup: NN_Wrapper, nn_count: int,
):
    """The reference's ``predict_multiple_model``: :func:`predict_model`."""
    return predict_model(
        model, params, test_features, train_features, train_responses,
        nbrs_lookup, nn_count,
    )
