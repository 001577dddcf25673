"""Plain reference of Fast MuyGPs' posterior mean: each query answered
from the precomputed coefficients of its nearest training point's
neighbourhood, with no solve of its own.

Written from the method's definition (Dunton, Priest, Muyskens, "Fast
Gaussian Process Posterior Mean Prediction via Local Cross Validation and
Precomputation", arXiv:2205.10879; MuyGPyS ``examples/
fast_posterior_mean.py``), in plain PyTorch.  For a query ``x``:

- ``j*``, its exact nearest training point;
- ``N``, the neighbourhood of ``j*``: ``j*`` itself and its ``nn - 1``
  nearest other training points, exactly;
- ``C = (K_in + eps I)^{-1} Y_N`` by a dense Cholesky, with the Matérn
  kernel and the nugget of ``reference/matern.py``;
- ``mu(x) = K(x, X_N) . C``.

Departures from the paper's description:

- the paper computes ``C`` for every training point offline; the reference
  solves only the neighbourhoods its queries need, each once (the same
  numbers for those queries);
- the neighbourhood is the point and its ``nn - 1`` nearest *others*, as
  MuyGPyS builds it (``fast_nn_update`` on a search that leaves the point
  out), where the paper speaks of a training point's nearest neighbours;
- equidistant points are ordered by the search of ``reference/knn.py``
  (the exact re-rank's stable sort), where the paper leaves ties open.

Distances are taken by direct differences.  Under the control's precision
the search's Gram products read TF32 (``reference/knn.py``), the
factorisation runs in float32, and every operand of the solve's products
(the factor, the targets, the coefficients, the crosswise row) is read as
TF32's products read it (``reference/precision.py``).
"""

from __future__ import annotations

import torch

from gpbench.reference import knn
from gpbench.reference.matern import _dist, matern, nugget
from gpbench.reference.precision import matmul_operand as op


def neighbourhoods(train_x: torch.Tensor, queries: torch.Tensor,
                   nn_count: int):
    """``(sets (S, nn), row (Q,))``: the neighbourhood of each distinct
    nearest training point the queries have, the point first, and the row
    of ``sets`` that answers each query."""
    nearest = knn.knn(train_x, queries, 1)[:, 0]
    points, row = torch.unique(nearest, return_inverse=True)
    found = knn.knn(train_x, train_x[points], nn_count + 1)
    # the point's own entry (distance 0) moves last, the others keep their
    # order; the first nn - 1 of them join the point
    own = (found == points[:, None]).to(torch.int8)
    order = torch.argsort(own, dim=1, stable=True)
    others = torch.gather(found, 1, order[:, :nn_count - 1])
    return torch.cat([points[:, None], others], dim=1), row


def coefficients(train_x, train_y, sets, length_scale, noise, smoothness,
                 block=8192) -> torch.Tensor:
    """``C (S, nn)`` of each neighbourhood, in blocks; NaN where its
    factorisation fails."""
    out = []
    for s in range(0, sets.shape[0], block):
        idx = sets[s:s + block]
        nx = train_x[idx]  # (b, nn, d)
        K = nugget(matern(_dist(nx, nx), length_scale, smoothness), noise)
        L, info = torch.linalg.cholesky_ex(K)
        C = op(torch.cholesky_solve(op(train_y[idx][..., None]), op(L)))
        failed = torch.where(info > 0, torch.nan, 0.0).to(C.dtype)
        out.append(C[..., 0] + failed[:, None])
    return torch.cat(out)


def posterior_mean(train_x, train_y, queries, sets, row, length_scale,
                   noise, smoothness) -> torch.Tensor:
    """The fast posterior mean ``(Q,)`` of each query from the coefficients
    of its row of ``sets``."""
    C = coefficients(train_x, train_y, sets, length_scale, noise, smoothness)
    nx = train_x[sets[row]]  # (Q, nn, d)
    kc = matern(_dist(queries[:, None, :], nx)[:, 0, :], length_scale,
                smoothness)
    return torch.sum(op(kc) * C[row], dim=-1)
