"""Spans of the serving and search paths, on the profiler's own clock.

``with span("muygpys.<layer>.<what>"): ...`` marks a stretch of host work.
A span is on exactly while a :mod:`torch.profiler` session records, and is
then a kineto ``cpu_op`` event: it shares its timestamps with the CUPTI
device activities of the same trace, so each stretch in which the card
idles can be set against the span open on the host at the time.  Spans
nest by time on the one host thread; the spans of one request lie inside
its ``muygpys.serve.predict``.  With no profiler recording, a span is one
flag check and a shared null context: no flag, environment variable or
file of the program's own turns it on.

The spans are not :func:`torch.profiler.record_function`: that writes a
``user_annotation`` event, which the profiler mirrors onto the device's
timeline as a CUDA activity lasting from the span's first kernel to its
last, and which would fill the device's idle time inside it.

The spans:

- ``muygpys.serve.predict``: one :meth:`FastServer.predict` call;
- ``muygpys.serve.stage``: a bucket's slice, edge pad and host-to-device
  copy;
- ``muygpys.serve.replay``: a bucket's captured graph replayed (the eager
  core called, where nothing is captured);
- ``muygpys.serve.readback``: a bucket's outputs copied back to the host
  (the wait for the device included);
- ``muygpys.nn.get_nns``: one search of :class:`NN_Wrapper`, every method,
  to its numpy outputs;
- ``muygpys.nn.candidates``: its candidate search (the tiled exact search,
  or K3), or on the exact kernel's route the whole search;
- ``muygpys.nn.refine``: its exact re-rank (none on the exact kernel's
  route);
- ``muygpys.graph.capture``: a :class:`CapturedProgram`'s warm-up and
  capture.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` in a recording profiler's trace;
    a shared null context when none records."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL
