"""Process-group bring-up and device meshes.

Counterpart of :mod:`muygpys_tpu.parallel.mesh`.  JAX builds a
``jax.sharding.Mesh`` over devices and lets XLA place collectives; here a
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks
of a ``torch.distributed`` world, one rank per device.  A rank's device is
``cuda:<local rank>`` (``LOCAL_RANK``, else the rank modulo the visible
cards), or the CPU when the caller passes ``device="cpu"``.  The backend
follows the device: NCCL on the card, gloo on the CPU.  Ranks that share one
card ask for gloo explicitly (``initialize_distributed(backend="gloo")``):
NCCL cannot put two ranks on one card.  Nothing switches backend or device
by itself.

The batch of independent neighborhoods is the only parallel axis, so a 1-D
mesh suffices; :func:`make_hybrid_mesh` gives the ``(nodes, local ranks)``
layout of a multi-node job.
"""

from __future__ import annotations

import os
import warnings
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from muygpys_torch import config

# the device type of the meshes this process builds, set at bring-up
_DEVICE = {"type": "cuda"}


def _card(rank: int) -> torch.device:
    """The card of a rank: ``LOCAL_RANK`` (else the rank) modulo the
    visible cards, so ranks sharing a card share ``cuda:0``."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def rank_device() -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (modulo the visible
    cards), or the CPU when the world was brought up with
    ``device="cpu"``."""
    if _DEVICE["type"] == "cpu":
        return torch.device("cpu")
    return _card(dist.get_rank())


def initialize_distributed(device=None, backend: Optional[str] = None,
                           **kwargs) -> bool:
    """Bring up the ``torch.distributed`` world.

    - With kwargs (``coordinator_address`` ``"host:port"``,
      ``num_processes``, ``process_id``, as in JAX): explicit bring-up over
      the TCP init method; errors propagate.
    - With none: the ``torchrun`` environment (``MASTER_ADDR``,
      ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Where there is none this
      is a loud no-op, as in JAX: a warning, and ``False``.

    ``device`` (default ``"cuda"``) is where this rank computes; the
    backend follows it (NCCL on the card, gloo on the CPU) unless
    ``backend`` names one: ``backend="gloo"`` on the card is for ranks that
    share one card.  Returns True if the world is up after the call.
    """
    if dist.is_initialized():
        return True
    dev = config.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs device='cuda'")
    _DEVICE["type"] = dev.type
    timeout = timedelta(seconds=float(kwargs.pop("timeout", 600)))
    if kwargs:
        address = kwargs.pop("coordinator_address")
        world = int(kwargs.pop("num_processes"))
        rank = int(kwargs.pop("process_id"))
        if kwargs:
            raise TypeError(f"unexpected arguments {sorted(kwargs)}")
        init = dict(init_method=f"tcp://{address}", world_size=world,
                    rank=rank)
    else:
        needed = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
        missing = [k for k in needed if k not in os.environ]
        if missing:
            warnings.warn(
                "initialize_distributed(): no torchrun environment "
                f"({', '.join(missing)} unset); continuing single-process. "
                "If you expected several processes, launch with torchrun or "
                "pass coordinator_address/num_processes/process_id "
                "explicitly.",
                stacklevel=2,
            )
            return False
        rank, init = int(os.environ["RANK"]), {}
    if dev.type == "cuda":
        card = _card(rank)
        torch.cuda.set_device(card)
        if backend == "nccl":
            # the communicator's card, named rather than guessed
            init["device_id"] = card
    dist.init_process_group(backend, timeout=timeout, **init)
    return True


def _ranks(n_devices, devices) -> list:
    ranks = list(range(dist.get_world_size())) if devices is None else [
        int(d) for d in devices
    ]
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return ranks


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "batch",
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over the ranks ``devices`` (default:
    the whole world), or its first ``n_devices``.  Every rank of the world
    calls it, members of a sub-mesh or not (building its group is a
    collective step)."""
    ranks = _ranks(n_devices, devices)
    return DeviceMesh(
        _DEVICE["type"], ranks, mesh_dim_names=(axis_name,)
    )


def make_hybrid_mesh(
    axis_names: Sequence[str] = ("dcn", "ici"),
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """A 2-D ``(nodes, local ranks)`` mesh over the world: rows are nodes of
    ``LOCAL_WORLD_SIZE`` ranks each (``torchrun`` sets it; unset, the world
    is one node).  Sharding the batch over both axes keeps the rows
    process-major, as JAX's hybrid mesh does."""
    ranks = _ranks(None, devices)
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    if len(ranks) % per_node != 0:
        raise ValueError(
            f"{len(ranks)} ranks do not divide evenly over nodes of "
            f"{per_node}"
        )
    grid = np.asarray(sorted(ranks)).reshape(-1, per_node)
    return DeviceMesh(
        _DEVICE["type"], grid.tolist(), mesh_dim_names=tuple(axis_names)
    )


def mesh_size(mesh: DeviceMesh) -> int:
    return int(mesh.size())


def mesh_index(mesh: DeviceMesh) -> Optional[int]:
    """This rank's position in the mesh's row-major order (the order its
    batch shards follow), or ``None`` for a rank outside it."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))


def mesh_group(mesh: DeviceMesh):
    """The process group spanning every rank of ``mesh``."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh_size(mesh) != dist.get_world_size():
        raise ValueError(
            "a multi-axis mesh must span the whole world (build it with "
            "make_hybrid_mesh)"
        )
    return dist.group.WORLD


def mesh_backend(mesh: DeviceMesh) -> str:
    return dist.get_backend(mesh_group(mesh))


def local_chunk_slice(global_count: int, mesh: DeviceMesh) -> slice:
    """The rows of a batch sharded over ``mesh`` that THIS rank owns,
    computed against the mesh (which may span a subset of the world's
    ranks); empty for a rank outside it.  A count that does not divide the
    mesh's device count goes through
    :func:`muygpys_torch.parallel.sharding.shard_ragged_global`."""
    n_dev = mesh_size(mesh)
    if global_count % n_dev != 0:
        raise ValueError(
            f"batch {global_count} must divide the mesh's device count "
            f"{n_dev}; use sharding.shard_ragged_global (pads with edge "
            "rows and returns 0/1 row weights)"
        )
    per_dev = global_count // n_dev
    idx = mesh_index(mesh)
    if idx is None:
        return slice(0, 0)
    return slice(idx * per_dev, (idx + 1) * per_dev)
