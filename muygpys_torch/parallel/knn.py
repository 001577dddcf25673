"""Distributed exact KNN over sharded training data.

Counterpart of :mod:`muygpys_tpu.parallel.knn`: every rank holds a shard
of the training features and takes a LOCAL exact top-k for all queries
(the Gram identity in full float32: TF32 is off, :mod:`muygpys_torch.config`);
the per-rank candidate sets (k each) are all-gathered and merged with one
final top-k.  Communication is ``O(ranks * queries * k)``, independent of
the training size.  Local indices become global row numbers assuming equal
contiguous shards (the layout of :func:`muygpys_torch.parallel.shard`).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from muygpys_torch.parallel import comm
from muygpys_torch.parallel.mesh import (
    local_chunk_slice,
    mesh_group,
    mesh_size,
    rank_device,
)


def sharded_knn(
    train_sharded,
    queries,
    nn_count: int,
    mesh,
    axis_name: str = "batch",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global KNN with the train rows sharded over ``mesh``.

    Args:
        train_sharded: ``(train_count, feat)``, a DTensor sharded over the
            mesh (:func:`muygpys_torch.parallel.shard`) or the full tensor
            (each rank then takes its rows); ``train_count`` must divide by
            the mesh size.
        queries: ``(query_count, feat)``, the same on every rank.
        nn_count: neighbors per query.

    Returns ``(indices, sq_dists)`` with GLOBAL train row indices, ascending
    by distance, the same on every rank.
    """
    n_dev = mesh_size(mesh)
    train_count = train_sharded.shape[0]
    if train_count % n_dev != 0:
        raise ValueError(
            f"train_count {train_count} must divide the mesh size {n_dev}"
        )
    rows = local_chunk_slice(train_count, mesh)
    if isinstance(train_sharded, DTensor):
        local = train_sharded.to_local()
    else:
        local = torch.as_tensor(train_sharded)[rows]
    dev = rank_device()
    local = local.to(dev)
    q = torch.as_tensor(queries, dtype=local.dtype, device=dev)
    # local exact top-k on this rank's shard
    d2 = (
        torch.sum(q * q, -1)[:, None]
        + torch.sum(local * local, -1)[None, :]
        - 2.0 * (q @ local.T)
    )
    negd, idx = torch.topk(-d2, nn_count, dim=1)
    global_idx = idx + rows.start
    # every rank's candidates: (n_dev, q, k)
    group = mesh_group(mesh)
    all_negd = comm.all_gather(negd[None], group)
    all_idx = comm.all_gather(global_idx[None], group)
    q_count = q.shape[0]
    cand_negd = all_negd.permute(1, 0, 2).reshape(q_count, n_dev * nn_count)
    cand_idx = all_idx.permute(1, 0, 2).reshape(q_count, n_dev * nn_count)
    negd_f, sel = torch.topk(cand_negd, nn_count, dim=1)
    idx_f = torch.gather(cand_idx, 1, sel)
    return idx_f, torch.clamp_min(-negd_f, 0.0)
