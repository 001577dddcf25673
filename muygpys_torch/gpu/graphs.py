"""Captured programs: a function captured once into a CUDA graph, replayed.

The port's counterpart of ``jax.jit`` where the JAX package compiles a
whole program once: a serving bucket (``muygpys_tpu/serve.py``'s per-bucket
``jax.jit``) and a whole L-BFGS trajectory
(``muygpys_tpu/optimize/device_chassis.py``'s ``while_loop``).  A
:class:`CapturedProgram` runs its function eagerly on a side stream first
(the warm-up builds every kernel, makes every library handle and constant
cache, and sets every kernel attribute), then captures it once into a
:class:`torch.cuda.CUDAGraph` on that stream.  A caller copies new inputs
into the static input tensors and replays the graph: no Python runs per
kernel, and nothing is read back to the host.

The kernels' launch counts (:data:`muygpys_torch.gpu._build.launches`)
follow the replays: the capture records the launches its function makes
(:func:`muygpys_torch.gpu._build.recording`) and every replay adds them
again, so a count says how often a kernel ran, captured or not.

A capture that fails raises, in torch's ``capture_error_mode="global"``
(a host read or a pageable copy inside the function is refused): nothing
falls back to the eager function.  Only CUDA tensors are captured; the CPU
paths of the port call their functions eagerly.  The warm-up and capture
lie in the ``muygpys.graph.capture`` span (:mod:`muygpys_torch.tracing`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import torch

from muygpys_torch.gpu import _build
from muygpys_torch.tracing import span

_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The stream this process warms up and captures on, one per device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


class CapturedProgram:
    """``fn(*inputs)`` captured once on CUDA tensors, replayed per call.

    Args:
        fn: a function of the static ``inputs`` returning tensors (or a
            tuple of them, or nothing); it must not read the device back to
            the host.
        inputs: the static input tensors; the caller copies each call's
            inputs into them before :meth:`replay`.
        warmup: eager runs of ``fn`` on the side stream before the capture
            (0 where the caller warms up itself: the device chassis steps
            a copy of its state, which ``fn`` would advance).

    :attr:`outputs` are the graph's own tensors: a replay overwrites them,
    so a caller copies out what it keeps before the next call.
    """

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor] = (),
                 warmup: int = 1, device=None):
        self.inputs = tuple(inputs)
        if device is None:
            device = self.inputs[0].device
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"a CUDA graph captures CUDA tensors, not {device}"
            )
        self.device = device
        stream = side_stream(device)
        with span("muygpys.graph.capture"):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(warmup):
                    fn(*self.inputs)
            self.graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with _build.recording() as counts:
                with torch.cuda.graph(self.graph, stream=stream):
                    self.outputs = fn(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(stream)
        #: host milliseconds of the capture (graph instantiation included)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        #: kernel launches of one replay, by count name
        self.launches = dict(counts)

    def replay(self):
        """Run the captured work once more on the current stream; returns
        :attr:`outputs`."""
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.outputs
