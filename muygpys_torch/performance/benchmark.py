"""Pipeline-stage benchmark harness.

Counterpart of :mod:`muygpys_tpu.performance.benchmark`: times each stage
of the MuyGPs pipeline (tensor assembly, kernel evaluation, posterior mean
and variance, the analytic scale, the LOO objective and its gradient) after
a warm-up call, and optionally records a profiler trace.  Work on a CUDA
device is timed between CUDA events (``torch.cuda.synchronize`` fences the
warm-up); work on the CPU on the host clock.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from typing import Callable, Dict, Optional

import numpy as np
import torch

from muygpys_torch import config


def _device_of(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out.device if torch.is_tensor(out) else torch.device("cpu")


def benchmark_fn(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 1,
    **kwargs,
) -> float:
    """Steady-state seconds per call of ``fn``: ``warmup`` calls, then
    ``iters`` calls between two CUDA events where ``fn`` returns CUDA
    tensors (between host clock readings otherwise)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    dev = _device_of(out)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters


class BenchmarkPipeline:
    """Times every stage of a MuyGPs predict/objective pipeline.

    Args:
        muygps: the model to benchmark.
        batch_count / nn_count / feature_count / response_count: shapes.
        profile_dir: if set, record the run with ``torch.profiler`` and
            write its Chrome trace to ``profile_dir/trace.json``.
        seed: the numpy seed of the features, targets and neighbors (drawn
            in the JAX harness's order).
        device: where the tensors live (default ``"cuda"``).
    """

    def __init__(
        self,
        muygps,
        batch_count: int = 2048,
        nn_count: int = 30,
        feature_count: int = 4,
        response_count: int = 1,
        profile_dir: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        self.muygps = muygps
        self.profile_dir = profile_dir
        self.device = config.device(device)
        rng = np.random.default_rng(seed)
        dtype = config.ftype()
        self.features = torch.as_tensor(
            rng.uniform(size=(batch_count * 2, feature_count)), dtype=dtype,
            device=self.device,
        )
        self.targets = torch.as_tensor(
            rng.standard_normal((batch_count * 2, response_count)),
            dtype=dtype, device=self.device,
        )
        self.batch_indices = torch.arange(batch_count, device=self.device)
        self.nn_indices = torch.as_tensor(
            rng.integers(batch_count, batch_count * 2,
                         size=(batch_count, nn_count)),
            device=self.device,
        )

    def _profiler(self):
        if not self.profile_dir:
            return nullcontext()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def run(self, iters: int = 10) -> Dict[str, float]:
        """Seconds per call of each pipeline stage."""
        from muygpys_torch.optimize import L_BFGS_B_optimize, lool_fn

        m = self.muygps
        deformation = m.kernel.deformation
        timings: Dict[str, float] = {}
        with self._profiler() as prof:

            def pairwise_fn(f):
                return deformation.pairwise_tensor(f, self.nn_indices)

            def crosswise_fn(f):
                return deformation.crosswise_tensor(
                    f, f, self.batch_indices, self.nn_indices
                )

            timings["pairwise_tensor"] = benchmark_fn(
                pairwise_fn, self.features, iters=iters
            )
            timings["crosswise_tensor"] = benchmark_fn(
                crosswise_fn, self.features, iters=iters
            )

            pairwise = pairwise_fn(self.features)
            crosswise = crosswise_fn(self.features)
            timings["kernel_Kin"] = benchmark_fn(m.kernel, pairwise,
                                                 iters=iters)
            timings["kernel_Kcross"] = benchmark_fn(m.kernel, crosswise,
                                                    iters=iters)

            Kin = m.kernel(pairwise)
            Kcross = m.kernel(crosswise)
            nn_targets = self.targets[self.nn_indices]
            timings["posterior_mean"] = benchmark_fn(
                m.posterior_mean, Kin, Kcross, nn_targets, iters=iters
            )
            timings["posterior_variance"] = benchmark_fn(
                m.posterior_variance, Kin, Kcross, iters=iters
            )
            timings["scale_optim"] = benchmark_fn(
                m.scale.get_opt_fn(m), Kin, nn_targets, iters=iters
            )

            batch_targets = self.targets[self.batch_indices]
            obj_fn = L_BFGS_B_optimize.make_obj_fn(
                m, batch_targets, nn_targets, crosswise, pairwise,
                loss_fn=lool_fn,
            )
            names, x0, _ = m.get_opt_params()
            if len(names):
                def params(grad):
                    return {
                        n: torch.tensor(float(x0[i]), dtype=pairwise.dtype,
                                        device=self.device,
                                        requires_grad=grad)
                        for i, n in enumerate(names)
                    }

                def objective():
                    with torch.no_grad():
                        return obj_fn(**params(False))

                def objective_grad():
                    p = params(True)
                    return torch.autograd.grad(obj_fn(**p), list(p.values()))

                timings["lool_objective"] = benchmark_fn(objective,
                                                         iters=iters)
                timings["lool_objective_grad"] = benchmark_fn(
                    objective_grad, iters=iters
                )
        if prof is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(self.profile_dir, "trace.json")
            )
        return timings
