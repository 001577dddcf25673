"""The collectives of the sharded paths, and the batch reductions over them.

The JAX package never calls a collective by hand: ``jnp.sum`` over a
sharded batch axis lowers to an all-reduce that XLA inserts.  Eager PyTorch
has no such lowering, so every reduction over a sharded batch goes through
this module:

- :func:`batch_sum` / :func:`batch_total`: a sum of per-row terms, or a row
  count, over the batch.  Outside :func:`reducing` they are ``torch.sum``
  and the count itself; inside, the local value is all-reduced over the
  group, so the losses of :mod:`muygpys_torch.ops.loss` and the analytic
  sigma^2 of :mod:`muygpys_torch.ops.scale` read the GLOBAL batch.
- :func:`all_reduce` / :func:`all_gather`: sums and concatenations of
  tensors over a group.

Gradients.  An all-reduce here is differentiable: its backward all-reduces
the incoming gradient, the adjoint of a sum over ranks when each rank holds
a share of the gradient.  A replicated parameter enters a sharded objective
through :func:`replicated`, whose backward is the MEAN over ranks.  Together
every rank ends with the gradient of the one global value, whatever the
order of reductions and replicated steps between them: without the mean,
autograd through an all-reduce of a replicated loss multiplies the gradient
by the world size.

A group of one rank issues no collective (XLA's one-device program has
none), and each collective adds its bytes to :data:`bytes_moved` (an
all-reduce counts its tensor, an all-gather its gathered output, as an HLO
module's result shapes do), which
:func:`muygpys_torch.performance.scaling.collective_bytes` reads.

Under the gloo backend the tensors of a collective may lie on a CUDA device:
gloo stages them through host memory itself.  Such a collective cannot be
captured in a CUDA graph, so under gloo the serving engines run eagerly
(:class:`muygpys_torch.serve.FastServer`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch
import torch.distributed as dist

#: bytes each collective kind moved on this rank
bytes_moved: Dict[str, int] = {}

_GROUP = contextvars.ContextVar("reduction_group", default=None)


def group_size(group) -> int:
    return dist.get_world_size(group)


def _count(kind: str, t: torch.Tensor) -> None:
    bytes_moved[kind] = (
        bytes_moved.get(kind, 0) + t.numel() * t.element_size()
    )


@contextlib.contextmanager
def reducing(group):
    """Inside this context :func:`batch_sum` and :func:`batch_total` reduce
    over ``group`` (a process group; ``None`` reduces nothing)."""
    token = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(token)


def active():
    """The group the batch reductions run over, or ``None``."""
    return _GROUP.get()


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    _count("all-reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone().contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone().contiguous(), ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = _all_reduce_(grad.clone().contiguous(), ctx.group)
        return g / group_size(ctx.group), None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (default: the active
    one), differentiable; ``x`` itself on a group of one or none."""
    group = active() if group is None else group
    if group is None or group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, group)
    return _all_reduce_(x.clone().contiguous(), group)


def replicated(x, group=None):
    """A replicated parameter as it enters a sharded computation: itself in
    the forward pass; its gradient is averaged over the ranks (see the
    module docstring)."""
    group = active() if group is None else group
    if (group is None or group_size(group) == 1 or not torch.is_tensor(x)
            or not x.requires_grad):
        return x
    return _Replicated.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order (not
    differentiable)."""
    group = active() if group is None else group
    if group is None or group_size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty(
        (group_size(group) * x.shape[0],) + tuple(x.shape[1:]),
        dtype=x.dtype, device=x.device,
    )
    _count("all-gather", out)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def batch_sum(terms: torch.Tensor) -> torch.Tensor:
    """``torch.sum(terms)`` over the whole batch: the local sum, all-reduced
    over the active group."""
    return all_reduce(torch.sum(terms))


def batch_total(count, like: torch.Tensor):
    """A row count (or weight total) over the whole batch.  Outside
    :func:`reducing` the count itself; inside, the local count all-reduced
    (as a tensor of ``like``'s dtype and device)."""
    if active() is None:
        return count
    return all_reduce(torch.as_tensor(count, dtype=like.dtype,
                                      device=like.device))
