"""Exact nearest neighbours, plain PyTorch, in blocks of queries.

Squared distances by the Gram identity ``|q|^2 + |t|^2 - 2 q.t`` (one
matrix product a block), an over-fetched top-k, then an exact re-rank of
the candidates by direct differences.  In float64 the identity's rounding
(~1e-16 on coordinates in the unit square) lies far below the gaps between
neighbours; run in a lower precision (the control) it scrambles them.
"""

from __future__ import annotations

import torch

from gpbench.reference.precision import matmul_operand

OVERFETCH = 32


def knn(train: torch.Tensor, queries: torch.Tensor, k: int,
        block: int = 256) -> torch.Tensor:
    """Indices ``(Q, k)`` of each query's ``k`` nearest training rows,
    nearest first, in ``train``'s dtype and device."""
    fetch = min(k + OVERFETCH, train.shape[0])
    norms = torch.sum(train * train, dim=1)
    train_op = matmul_operand(train)
    out = []
    for start in range(0, queries.shape[0], block):
        q = queries[start:start + block]
        d2 = torch.addmm(norms, matmul_operand(q), train_op.T, alpha=-2.0)
        _, cand = torch.topk(d2, fetch, dim=1, largest=False)
        exact = torch.sum((train[cand] - q[:, None, :]) ** 2, dim=-1)
        order = torch.argsort(exact, dim=1, stable=True)[:, :k]
        out.append(torch.gather(cand, 1, order))
    return torch.cat(out)
