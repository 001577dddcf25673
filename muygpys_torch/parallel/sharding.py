"""Batch-dimension sharding.

Counterpart of :mod:`muygpys_tpu.parallel.sharding`.  A sharded array is a
:class:`torch.distributed.tensor.DTensor` placed ``Shard(0)`` over a mesh
(PyTorch's counterpart of a sharded ``jax.Array``), a replicated one a
``Replicate()`` DTensor.  Every rank passes the FULL host array and keeps
its own row chunk, so there is no scatter: :func:`shard` and
:func:`shard_global` are one function under two names, as are the other
``*_global`` pairs (JAX tells single- from multi-process placement apart;
``torch.distributed`` is always multi-process).

The model code does not change.  Entry points that take a batch
(``OptimizeFn.make_obj_fn`` and the chassis, the fused K2 objective, the
shear objective, ``FastServer``) find the mesh from their DTensor inputs
and compute on each rank's local rows; DTensor itself has no sharding rule
for batched ``torch.linalg``, and the kernels take plain tensors.  Every
reduction over the batch is an explicit collective
(:mod:`muygpys_torch.parallel.comm`).  :func:`shard_map` runs any function
of batch tensors the same way, as ``jax.shard_map`` does.

Ragged batches go through :func:`shard_ragged`: edge-row padding to a mesh
multiple and 0/1 ``row_weights`` that every loss and the analytic scale
honor, so padded rows are semantically absent.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from muygpys_torch.parallel import comm
from muygpys_torch.parallel.mesh import (
    local_chunk_slice,
    mesh_group,
    mesh_size,
    rank_device,
)


def batch_spec(mesh, ndim: int = 1, axis_name: Optional[str] = None):
    """The placements sharding the leading dim: over every mesh axis
    jointly (row-major, so a hybrid mesh keeps the rows process-major), or
    over ``axis_name`` alone, replicated over the others.  ``ndim`` is
    JAX's argument and changes nothing (placements name no trailing dims).
    """
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name is None:
        return [Shard(0)] * mesh.ndim
    return [Shard(0) if n == axis_name else Replicate() for n in names]


def _as_tensor(x):
    if isinstance(x, DTensor):
        return x.full_tensor()
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x))


def shard(x, mesh, axis_name: Optional[str] = None) -> DTensor:
    """``x`` with its leading (batch) axis sharded over the mesh: every
    rank passes the full array and keeps its own rows, on its device."""
    x = _as_tensor(x)
    placements = batch_spec(mesh, x.ndim, axis_name)
    sub = mesh if axis_name is None or mesh.ndim == 1 else mesh[axis_name]
    rows = local_chunk_slice(x.shape[0], sub)
    local = x[rows].contiguous().to(rank_device())
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=x.shape,
        stride=torch.empty(x.shape, device="meta").stride(),
    )


def replicate(x, mesh) -> DTensor:
    """``x`` replicated over the mesh."""
    x = _as_tensor(x).to(rank_device())
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard_batch(tensors, mesh, axis_name: Optional[str] = None):
    """:func:`shard` over a tuple or list of tensors."""
    return type(tensors)(shard(t, mesh, axis_name) for t in tensors)


def even_batch(batch_count: int, mesh) -> int:
    """Largest batch size <= batch_count divisible by the mesh size."""
    n = mesh_size(mesh)
    return (batch_count // n) * n


def shard_ragged(tensors, mesh, axis_name: Optional[str] = None):
    """Shard a batch whose size does not divide the mesh: pad + mask.

    Pads every tensor's leading axis up to a mesh multiple with copies of
    its last row (keeping kernel matrices well-conditioned) and returns
    ``(padded_sharded_tensors, row_weights)``, where ``row_weights`` is a
    0/1 vector sharded the same way.  Pass it as ``loss_kwargs=
    {"row_weights": row_weights}``: every loss and the analytic scale weight
    per-row terms by it, so the objective, its gradient and sigma^2 equal
    the unpadded serial values.
    """
    full = [_as_tensor(t) for t in tensors]
    batch = int(full[0].shape[0])
    n = mesh_size(mesh)
    padded = -(-batch // n) * n
    pad = padded - batch

    def pad_one(t):
        if pad:
            t = torch.cat([t] + [t[-1:]] * pad, dim=0)
        return shard(t, mesh, axis_name)

    out = type(tensors)(pad_one(t) for t in full)
    weights = (torch.arange(padded) < batch).to(full[0].dtype
                                               if full[0].is_floating_point()
                                               else torch.float64)
    return out, shard(weights, mesh, axis_name)


shard_global = shard
shard_batch_global = shard_batch
shard_ragged_global = shard_ragged


def gather_global(x) -> np.ndarray:
    """A (possibly sharded) tensor materialized on the host; a sharded one
    is all-gathered, so every rank of its mesh calls this."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def local_parts(args):
    """``(mesh, args)`` with every DTensor of ``args`` (a sequence) replaced
    by its local rows; ``mesh`` is theirs, or ``None`` when there is none."""
    mesh = None
    out = []
    for a in args:
        if isinstance(a, DTensor):
            if mesh is None:
                mesh = a.device_mesh
            elif a.device_mesh != mesh:
                raise ValueError("sharded inputs lie on different meshes")
            a = a.to_local()
        out.append(a)
    return mesh, out


def sharded_batch(tensors):
    """``(group, local tensors)`` of a batch passed to an entry point: the
    group spans the mesh of its DTensors (``None`` for plain tensors)."""
    mesh, local = local_parts(list(tensors))
    return (None if mesh is None else mesh_group(mesh)), local


def shard_map(fn, mesh=None, out_specs="shard"):
    """``fn`` run on each rank's local rows, as ``jax.shard_map`` runs a
    function per device: DTensor arguments (positional or keyword) become
    their local tensors, every batch reduction inside (the losses, the
    analytic scale) runs over the mesh's group, and each output is a
    ``Shard(0)`` DTensor (``out_specs="shard"``) or a plain tensor that is
    the same on every rank (``"replicate"``: a reduced value).  A sequence
    of specs gives one per output.  ``mesh`` defaults to the inputs'."""

    @functools.wraps(fn)
    def mapped(*args, **kwargs):
        keys = list(kwargs)
        m, local = local_parts(list(args) + [kwargs[k] for k in keys])
        m = mesh if mesh is not None else m
        if m is None:
            raise ValueError("shard_map found no mesh: pass mesh= or a "
                             "sharded input")
        largs = local[:len(args)]
        lkw = dict(zip(keys, local[len(args):]))
        with comm.reducing(mesh_group(m)):
            out = fn(*largs, **lkw)
        single = not isinstance(out, (tuple, list))
        outs = (out,) if single else tuple(out)
        specs = ([out_specs] * len(outs) if isinstance(out_specs, str)
                 else list(out_specs))
        wrapped = tuple(
            DTensor.from_local(o, m, batch_spec(m), run_check=False)
            if s == "shard" else o
            for o, s in zip(outs, specs)
        )
        return wrapped[0] if single else wrapped

    return mapped
