"""On-device L-BFGS chassis: whole training trajectories as CUDA graphs.

Counterpart of :mod:`muygpys_tpu.optimize.device_chassis`, which runs
optax's L-BFGS (two-loop recursion and zoom line search) in one
``lax.while_loop`` under one ``jit``, every line-search probe included.
Here the optimizer is the branch-free state machine of
:mod:`muygpys_torch.optimize.lbfgs`, one objective evaluation a step.  On a
CUDA device :data:`STEPS_PER_REPLAY` steps are captured once into one CUDA
graph (:class:`muygpys_torch.gpu.graphs.CapturedProgram`), after one eager
warm-up step on a copy of the state, and the host replays the graph from
the start, reading the ``done`` flag (and whether the probe at the start
was finite) once per replay through a pinned buffer, until the trajectory
ends.  A step after
``done`` changes nothing, so the last replay's spare steps are harmless
(their kernels still run, and count).  On the CPU the same steps run
eagerly.  The objectives step inside
:func:`muygpys_torch.ops.solve.sync_free`: a failed factorization is NaN,
scored as :data:`~muygpys_torch.optimize.lbfgs.BIG` as in JAX, and nothing
reads the device back to the host.

Convergence is scipy L-BFGS-B's (``gtol``, ``ftol``, ``maxiter``), in the
unconstrained z-space of :mod:`muygpys_torch.optimize.bijectors`; the
optimizer's state is float64 whatever the objective's dtype.

Entry points:

- :data:`Device_LBFGS_optimize`: ``OptimizeFn`` over the generic LOO
  objective, its backward pass by ``torch.autograd`` inside the step;
- :func:`Fused_Device_LBFGS_optimize`: ``engine="kernel"`` (the JAX
  ``"pallas"``) evaluates K2 (value and analytic gradient, a free smoothness
  included), ``engine="lanes"`` the batched-layout objective under
  autograd; a shear model trains on the batched shear assembly;
- :func:`make_device_trainer`: one program per batch shape, trained on any
  batch of that shape (copied into its static buffers, no new capture);
- :func:`device_lbfgs` and :func:`lbfgs_while_loop` over any function of a
  1-D tensor.

Each runs where its tensors are; inputs that are not tensors (numpy, lists)
go on ``device``, CUDA unless the caller passes ``device="cpu"``.

Unlike the JAX chassis nothing falls back: on a card a capture or a launch
that fails raises, as does a probe at the initial point that is not
finite.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp.kernels.experimental import (
    ShearKernel,
    ShearKernel2in3out,
)
from muygpys_torch.gpu.graphs import CapturedProgram, side_stream
from muygpys_torch.ops import solve as _solve
from muygpys_torch.optimize import bijectors, lbfgs
from muygpys_torch.optimize.chassis import (
    OptimizeFn,
    _get_opt_lists,
    _new_muygps,
)
from muygpys_torch.optimize.fast_objective import (
    fast_objective_supports,
    make_fast_loo_objective,
)
from muygpys_torch.optimize.fused_objective import make_fused_train_objective
from muygpys_torch.optimize.loss import LossFn
from muygpys_torch.optimize.objective import make_loo_crossval_fn
from muygpys_torch.optimize.shear_objective import (
    make_shear_loo_objective,
    shear_objective_supports,
)

#: L-BFGS steps (objective evaluations) in one captured graph.  The training
#: headline's runs take 21-28 evaluations (NVIDIA H100 80GB HBM3, 700 W,
#: chip_smoke.py): 8 keeps the spare steps of the last replay, and the
#: capture, short, for a host read of ``done`` every 8 evaluations
STEPS_PER_REPLAY = 8
#: the optimizer state's dtype (the objective keeps its own)
Z_DTYPE = torch.float64

_finite_or_big = lbfgs.finite_or_big


class Trajectory:
    """Runs the L-BFGS state machine of one objective to its end, from any
    start: eagerly on the CPU, as replays of one captured graph on a card.

    ``value_and_grad(z) -> (value, grad)`` takes and returns float64
    tensors on ``device``: the value to MINIMIZE, already made finite.  The
    state's tensors are static: a run copies its start into them and
    replays the graph from there, so the graph captured at the first run
    serves every later one (:func:`make_device_trainer`).
    """

    def __init__(self, value_and_grad, dim, device, maxiter=200, gtol=1e-7,
                 ftol=2.22e-9, memory_size=lbfgs.MEMORY_SIZE):
        self.value_and_grad = value_and_grad
        self.device = torch.device(device)
        self.maxiter, self.gtol, self.ftol = maxiter, gtol, ftol
        self.memory_size = memory_size
        self.state = lbfgs.init_state(
            torch.zeros(dim, dtype=Z_DTYPE, device=self.device), memory_size
        )
        self.program: Optional[CapturedProgram] = None
        if self.device.type == "cuda":
            # done and start_ok, read once per replay
            self._flags = torch.zeros(2, dtype=torch.bool, device=self.device)
            self._flags_host = torch.zeros(2, dtype=torch.bool,
                                           pin_memory=True)
            self._event = torch.cuda.Event()

    @property
    def captures(self) -> int:
        return 0 if self.program is None else 1

    def _step(self, state):
        return lbfgs.step(state, self.value_and_grad, self.maxiter,
                          self.gtol, self.ftol, out=state)

    def _steps(self):
        for _ in range(STEPS_PER_REPLAY):
            self._step(self.state)
        torch.stack([self.state["done"], self.state["start_ok"]],
                     out=self._flags)

    def _check_start(self, ok: bool):
        if not ok:
            raise ValueError(
                "objective is non-finite at the initial point; check the "
                "model's initial hyperparameters"
            )

    def run(self, z0: torch.Tensor) -> dict:
        """Optimize from ``z0`` (1-D); returns the info dict: ``z`` (the
        final iterate, float64 on the device), ``iterations``, ``value``,
        ``grad_norm``, ``evaluations``, ``replays`` (host reads of
        ``done``; steps on the CPU), ``steps_per_replay``, ``capture_ms``
        (0 on the CPU and once captured) and ``wall_ms``."""
        t0 = time.perf_counter()
        fresh = lbfgs.init_state(
            torch.as_tensor(z0, dtype=Z_DTYPE, device=self.device).reshape(-1),
            self.memory_size,
        )
        for key in lbfgs.FLATS:
            self.state[key].copy_(fresh[key])
        bound = lbfgs.max_steps(self.maxiter)
        capture_ms, reads = 0.0, 0
        if self.device.type != "cuda":
            with _solve.sync_free():
                self._step(self.state)
                self._check_start(bool(self.state["start_ok"]))
                for _ in range(bound - 1):
                    reads += 1
                    if bool(self.state["done"]):
                        break
                    self._step(self.state)
        else:
            if self.program is None:
                # the warm-up: one eager step on a copy of the state (its
                # probe at the start is checked before anything is
                # captured), then the capture of the steps from the start
                stream = side_stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with _solve.sync_free(), torch.cuda.stream(stream):
                    warm = self._step(lbfgs.clone_state(self.state))
                torch.cuda.current_stream(self.device).wait_stream(stream)
                self._check_start(bool(warm["start_ok"]))
                with _solve.sync_free():
                    self.program = CapturedProgram(
                        self._steps, warmup=0, device=self.device
                    )
                capture_ms = self.program.capture_ms
            for _ in range(math.ceil(bound / STEPS_PER_REPLAY)):
                self.program.replay()
                self._flags_host.copy_(self._flags, non_blocking=True)
                self._event.record()
                self._event.synchronize()
                reads += 1
                self._check_start(bool(self._flags_host[1]))
                if bool(self._flags_host[0]):
                    break
        z, iters, value, gmax = lbfgs.summary(self.state)
        return dict(
            z=z.clone(), iterations=int(iters), value=float(value),
            grad_norm=float(gmax), evaluations=int(self.state["evals"]),
            replays=reads, steps_per_replay=STEPS_PER_REPLAY,
            capture_ms=capture_ms,
            wall_ms=(time.perf_counter() - t0) * 1e3,
        )


def _theta_of(names, bounds):
    """``z (float64, ordered as names) -> {name: theta}`` by the bijector,
    each value cast to the objective's dtype."""
    bounds = np.asarray(bounds, float)

    def theta_of(z, dtype):
        return {
            n: bijectors.forward(z[i], float(bounds[i, 0]),
                                 float(bounds[i, 1])).to(dtype)
            for i, n in enumerate(names)
        }

    return theta_of


def _autograd_vag(objective: Callable, names, bounds, dtype):
    """``z -> (finite_or_big(-objective(theta(z))), d/dz)`` by autograd;
    ``objective`` takes the dict of theta tensors."""
    theta_of = _theta_of(names, bounds)

    def fun(z):
        return -objective(theta_of(z, dtype)).to(Z_DTYPE)

    return lbfgs.autograd_value_and_grad(fun)


def _analytic_vag(objective, bounds, device):
    """The same from K2's value and analytic theta-gradient, the chain rule
    applied on the device as JAX's ``custom_vjp`` applies it: the cotangent
    of a non-finite value is zero."""
    bounds = torch.as_tensor(np.asarray(bounds, float), dtype=Z_DTYPE,
                             device=device)
    lo, hi = bounds[:, 0], bounds[:, 1]

    def value_and_grad(z):
        v, g = objective.evaluate(bijectors.forward(z, lo, hi))
        w = -v.to(Z_DTYPE)
        ct = -torch.isfinite(w).to(Z_DTYPE)
        grad = (ct * g.to(Z_DTYPE)) * bijectors.dforward_dz(z, lo, hi)
        return lbfgs.finite_or_big(w), grad

    return value_and_grad


def _start(muygps, verbose):
    names, x0, bounds = _get_opt_lists(muygps, verbose=verbose)
    lo, hi = bounds[:, 0], bounds[:, 1]
    return names, bounds, bijectors.inverse_np(x0, lo, hi)


def _finish(muygps, names, bounds, info, verbose, label):
    if verbose:
        print(f"device lbfgs ({label}): " + str(
            {k: v for k, v in info.items() if k != "z"}
        ))
    theta = _theta_of(names, bounds)(info["z"], Z_DTYPE)
    return _new_muygps(
        muygps, names, bounds, {n: float(t) for n, t in theta.items()}
    )


def _placed(arrays, device=None):
    """The arrays as tensors on one device: where they already all are, or,
    when ``device`` is given or any is not a tensor, on
    :func:`muygpys_torch.config.device` (CUDA unless the caller asks for the
    CPU)."""
    if device is None and all(isinstance(a, torch.Tensor) for a in arrays):
        return [a.to(arrays[-1].device) for a in arrays]
    dev = config.device(device)
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _autograd_trajectory(fun, z0, maxiter, gtol, ftol, memory_size):
    return Trajectory(
        lbfgs.autograd_value_and_grad(lambda z: fun(z).to(Z_DTYPE)),
        z0.numel(), z0.device, maxiter, gtol, ftol, memory_size,
    )


def lbfgs_while_loop(fun: Callable, z0, maxiter: int = 200,
                     gtol: float = 1e-7, ftol: float = 2.22e-9,
                     memory_size: int = lbfgs.MEMORY_SIZE, device=None):
    """The L-BFGS trajectory of ``fun`` (a torch function of a 1-D tensor,
    differentiated by autograd) from ``z0``: ``(z_final, iterations,
    value, max|grad|)`` as tensors, as the JAX function returns them (the
    state in float64).  A tensor ``z0`` runs on its device, anything else
    on ``device`` (default CUDA); see :func:`device_lbfgs`."""
    (z0,) = _placed([z0], device)
    run = _autograd_trajectory(fun, z0, maxiter, gtol, ftol, memory_size)
    run.run(z0)
    return tuple(t.clone() for t in lbfgs.summary(run.state))


def device_lbfgs(fun: Callable, z0, maxiter: int = 200, gtol: float = 1e-7,
                 ftol: float = 2.22e-9, memory_size: int = lbfgs.MEMORY_SIZE,
                 device=None):
    """Minimize ``fun(z) -> scalar`` (a torch function of a 1-D tensor,
    differentiated by autograd) from ``z0``: replays of one captured graph
    on a card, eager steps on the CPU.  A tensor ``z0`` runs on its device;
    anything else (a list, a numpy array) on ``device``, CUDA unless the
    caller passes ``device="cpu"``.  Returns ``(z_final, info)``; ``info``
    holds ``iterations``, ``value``, ``grad_norm`` and the run's counts."""
    (z0,) = _placed([z0], device)
    run = _autograd_trajectory(fun, z0, maxiter, gtol, ftol, memory_size)
    info = run.run(z0)
    return info.pop("z"), info


def _device_lbfgs_optimize(muygps, obj_fn, like, verbose=False, maxiter=200,
                           gtol=1e-7, ftol=2.22e-9, **kwargs):
    """The generic objective on the device chassis (maximization
    convention)."""
    names, bounds, z0 = _start(muygps, verbose)
    run = Trajectory(
        _autograd_vag(lambda theta: obj_fn(**theta), names, bounds,
                      like.dtype),
        len(names), like.device, maxiter, gtol, ftol,
    )
    return _finish(muygps, names, bounds, run.run(torch.as_tensor(z0)),
                   verbose, "generic")


class _DeviceOptimizeFn(OptimizeFn):
    """:class:`OptimizeFn` whose batch is placed by :func:`_placed` first:
    tensors on one device train there, anything else on ``device``
    (default CUDA)."""

    def __call__(self, muygps, batch_targets, batch_nn_targets,
                 crosswise_diffs, pairwise_diffs, *args, device=None,
                 **kwargs):
        batch = _placed([batch_targets, batch_nn_targets, crosswise_diffs,
                         pairwise_diffs], device)
        return super().__call__(muygps, *batch, *args, **kwargs)


Device_LBFGS_optimize = _DeviceOptimizeFn(_device_lbfgs_optimize,
                                          make_loo_crossval_fn)
"""The device chassis over the generic LOO objective."""


def _shear_unsupported(muygps, loss):
    return ValueError(
        f"the device chassis trains a shear model with loss 'mse', or "
        f"'lool' under a FixedScale; got loss {loss!r} with "
        f"{type(muygps.scale).__name__}.  Use the generic "
        "Device_LBFGS_optimize chassis, which re-estimates the scale at "
        "every evaluation"
    )


def Fused_Device_LBFGS_optimize(
    muygps,
    batch_targets,
    batch_nn_targets,
    crosswise_dists,
    pairwise_dists,
    loss: str = "lool",
    engine: str = "kernel",
    verbose: bool = False,
    interpret=None,
    maxiter: int = 200,
    gtol: float = 1e-7,
    ftol: float = 2.22e-9,
    batch_features=None,
    device=None,
    info: Optional[dict] = None,
    **kwargs,
):
    """The fused objective on the device chassis; returns the optimized
    model.  ``engine="kernel"`` evaluates K2 (value and analytic gradient;
    free smoothness and anisotropy included; a hierarchical length scale
    raises a ``ValueError`` naming ``engine="lanes"``), ``"lanes"`` the
    batched-layout objective (:func:`make_fast_loo_objective`, a
    hierarchical field at ``batch_features`` included) under autograd; a
    shear model trains on the batched shear assembly whatever ``engine``
    says; ``"pallas"`` (JAX's default) is ``"kernel"``, and JAX's
    ``interpret`` is taken and unused.
    Runs on ``device`` (default ``"cuda"``); pass a dict as ``info`` to
    receive the run's counts (iterations, evaluations, replays, capture
    and wall milliseconds)."""
    run, names, bounds, z0 = _fused_trajectory(
        muygps, batch_targets, batch_nn_targets, crosswise_dists,
        pairwise_dists, loss, engine, verbose, maxiter, gtol, ftol, device,
        batch_features,
    )
    result = run.run(z0)
    if info is not None:
        info.update(result)
    return _finish(muygps, names, bounds, result, verbose, engine)


def _fused_trajectory(muygps, batch_targets, batch_nn_targets,
                      crosswise_dists, pairwise_dists, loss="lool",
                      engine="kernel", verbose=False, maxiter=200, gtol=1e-7,
                      ftol=2.22e-9, device=None, batch_features=None):
    """``(Trajectory, names, bounds, z0)`` of
    :func:`Fused_Device_LBFGS_optimize`: a second ``run`` of the same
    trajectory replays its graph without a new capture (the smoke script
    traces one)."""
    engine = config.kernel_alias(engine)
    if engine not in ("kernel", "lanes"):
        raise ValueError(f"unknown engine {engine!r} (kernel, lanes)")
    dev = config.device(device)
    names, bounds, z0 = _start(muygps, verbose)
    args = (muygps, batch_targets, batch_nn_targets, crosswise_dists,
            pairwise_dists)
    dtype = torch.as_tensor(pairwise_dists).dtype
    if isinstance(muygps.kernel, (ShearKernel, ShearKernel2in3out)):
        if not shear_objective_supports(muygps, loss):
            raise _shear_unsupported(muygps, loss)
        obj, _ = make_shear_loo_objective(*args, loss=loss, layout="batched",
                                          device=dev)
        vag = _autograd_vag(obj, names, bounds, dtype)
    elif engine == "kernel":
        obj, _ = make_fused_train_objective(*args, loss=loss, device=dev)
        vag = _analytic_vag(obj, bounds, dev)
    else:
        obj, _ = make_fast_loo_objective(*args, loss=loss, layout="batched",
                                         batch_features=batch_features,
                                         device=dev)
        vag = _autograd_vag(obj, names, bounds, dtype)
    run = Trajectory(vag, len(names), dev, maxiter, gtol, ftol)
    return run, names, bounds, torch.as_tensor(z0)


def _loss_functor(loss):
    """``(loss name, generic LossFn or None)`` as the JAX trainer resolves
    them: a LossFn as given, a name through the loss module's registry."""
    if isinstance(loss, LossFn):
        return loss.name.removesuffix("_fn"), loss
    from muygpys_torch.optimize import loss as _loss_mod

    fn_name = {"huber": "pseudo_huber"}.get(loss, loss)
    functor = getattr(_loss_mod, f"{fn_name}_fn", None)
    return loss, functor if isinstance(functor, LossFn) else None


def make_device_trainer(
    muygps,
    loss: str = "lool",
    maxiter: int = 200,
    gtol: float = 1e-7,
    ftol: float = 2.22e-9,
    memory_size: int = lbfgs.MEMORY_SIZE,
    verbose: bool = False,
    device=None,
) -> Callable:
    """A device trainer: one program per batch shape, trained on every batch
    of that shape.

    Returns ``trainer(batch_targets, batch_nn_targets, crosswise_dists,
    pairwise_dists, z_init=None, batch_features=None) -> (MuyGPS, info)``.
    The first batch of a shape builds the objective over static buffers
    (and on a card captures its steps once); a later batch of the same
    shape is copied into the buffers and replays the same graph.
    ``batch_features`` (a hierarchical length scale's field is evaluated
    there) is a fifth buffer, refilled with each batch's features like the
    other four: the captured steps read the buffer, never the first
    batch's features.  ``info["z"]`` is the final
    unconstrained iterate: pass it as ``z_init`` to warm-start the next
    epoch.  ``trainer.cache_size()`` counts the programs built,
    ``trainer.captures()`` the graphs captured (0 on the CPU).

    The objective, as in the JAX trainer: the batched layout
    (:func:`make_fast_loo_objective`) for the model classes it covers, the
    batched shear assembly for the shear family, the generic composed
    objective otherwise (a loss name resolves through the loss module's
    registry).
    """
    dev = config.device(device)
    names, bounds, z0_default = _start(muygps, verbose)
    loss, loss_obj = _loss_functor(loss)
    use_fast = fast_objective_supports(muygps, loss)
    use_shear = (not use_fast) and shear_objective_supports(muygps, loss)
    if not (use_fast or use_shear) and loss_obj is None:
        raise ValueError(
            f"loss {loss!r} has no generic LossFn for the fallback"
        )
    from muygpys_torch.optimize.chassis import L_BFGS_B_optimize

    programs = {}

    def build(buffers):
        bt, bnt, cw, pw = buffers[:4]
        bf = buffers[4] if len(buffers) > 4 else None
        if use_fast:
            obj, _ = make_fast_loo_objective(
                muygps, bt, bnt, cw, pw, loss=loss, layout="batched",
                batch_features=bf, device=dev,
            )
        elif use_shear:
            obj, _ = make_shear_loo_objective(
                muygps, bt, bnt, cw, pw, loss=loss, layout="batched",
                device=dev,
            )
        else:
            raw = L_BFGS_B_optimize.make_obj_fn(
                muygps, bt, bnt, cw, pw, batch_features=bf, loss_fn=loss_obj
            )

            def obj(theta):
                return raw(**theta)

        vag = _autograd_vag(obj, names, bounds, pw.dtype)
        return Trajectory(vag, len(names), dev, maxiter, gtol, ftol,
                          memory_size)

    def trainer(batch_targets, batch_nn_targets, crosswise_dists,
                pairwise_dists, z_init=None, batch_features=None):
        arrays = (batch_targets, batch_nn_targets, crosswise_dists,
                  pairwise_dists)
        if batch_features is not None:
            arrays += (batch_features,)
        batch = [torch.as_tensor(t, device=dev) for t in arrays]
        dtype = batch[3].dtype
        batch = [t.to(dtype) for t in batch]
        key = tuple((tuple(t.shape), t.dtype) for t in batch)
        if key not in programs:
            buffers = [t.clone() for t in batch]
            programs[key] = (buffers, build(buffers))
        else:
            for dst, src in zip(programs[key][0], batch):
                dst.copy_(src)
        run = programs[key][1]
        z0 = z0_default if z_init is None else z_init
        info = run.run(torch.as_tensor(z0))
        if verbose:
            print(f"device trainer: {info}")
        return _finish(muygps, names, bounds, info, False, "trainer"), info

    trainer.cache_size = lambda: len(programs)
    trainer.captures = lambda: sum(p[1].captures for p in programs.values())
    return trainer
