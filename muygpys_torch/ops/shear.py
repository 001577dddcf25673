"""Weak-lensing shear kernel blocks.

Counterpart of :mod:`muygpys_tpu.ops.shear`: the multi-output covariance of
(convergence kappa, shear gamma1, shear gamma2), whose blocks are
second-order partial derivatives of an RBF kernel over 2-D sky coordinates.

Convention (the JAX package's and the reference's): ``length_scale`` enters
as ``exp(-sum_sq_diffs / (2 * length_scale))``, so it plays the role of the
*squared* length scale of the underlying RBF.

The six unique block images are computed once and stacked into
``prefix + (out_i, n, out_j, m)`` tensors.  Every block is an even
polynomial of the differences times the RBF, so ``Kin`` is symmetric term
by term.  ``length_scale`` may be a tensor that requires grad.
"""

from __future__ import annotations

import torch


def _block_ingredients(diffs: torch.Tensor, length_scale):
    """The six unique blocks over the trailing feature axis (size 2)."""
    ls = length_scale
    prod_diffs = torch.prod(diffs, dim=-1)
    sq = diffs**2
    quad = sq**2
    sum_sq = torch.sum(sq, dim=-1)
    prod_sq = torch.prod(sq, dim=-1)
    sum_quad = torch.sum(quad, dim=-1)
    diff_yx_sq = sq[..., 1] - sq[..., 0]
    diff_xy_sq = sq[..., 0] - sq[..., 1]
    diff_xy_quad = quad[..., 0] - quad[..., 1]
    e = torch.exp(-sum_sq / (2.0 * ls))
    inv_ls4 = 1.0 / ls**4

    kk = 0.25 * (
        (8.0 * ls**2 - 8.0 * ls * sum_sq + 2.0 * prod_sq + sum_quad)
        * e * inv_ls4
    )
    kg1 = 0.25 * ((6.0 * ls * diff_yx_sq + diff_xy_quad) * e * inv_ls4)
    kg2 = 0.5 * prod_diffs * (-6.0 * ls + sum_sq) * e * inv_ls4
    g1g1 = 0.25 * (
        (4.0 * ls**2 - 4.0 * ls * sum_sq - 2.0 * prod_sq + sum_quad)
        * e * inv_ls4
    )
    g1g2 = 0.5 * prod_diffs * diff_xy_sq * e * inv_ls4
    g2g2 = (ls**2 - ls * sum_sq + prod_sq) * e * inv_ls4
    return kk, kg1, kg2, g1g1, g1g2, g2g2


def _assemble(blocks) -> torch.Tensor:
    """Stack a list of rows of ``(..., n, m)`` blocks into
    ``(..., I, n, J, m)``, then drop EVERY size-1 axis (as the JAX
    package's ``jnp.squeeze`` does): zero differences ``(1, 1, 2)`` give the
    ``(I, J)`` prior, a crosswise ``(B, nn, 1, 2)`` gives ``(B, I, nn, J)``."""
    rows = [torch.stack(row, dim=-2) for row in blocks]  # (..., n, J, m)
    return torch.squeeze(torch.stack(rows, dim=-4))  # (..., I, n, J, m)


def shear_33_fn(diffs: torch.Tensor, length_scale=1.0, **kwargs):
    """Full 3-observable covariance (kappa, gamma1, gamma2) x same."""
    assert diffs.ndim >= 3
    kk, kg1, kg2, g1g1, g1g2, g2g2 = _block_ingredients(diffs, length_scale)
    return _assemble(
        [
            [kk, kg1, kg2],
            [kg1, g1g1, g1g2],
            [kg2, g1g2, g2g2],
        ]
    )


def shear_Kin23_fn(diffs: torch.Tensor, length_scale=1.0, **kwargs):
    """Shear-only (gamma1, gamma2) x (gamma1, gamma2) covariance."""
    assert diffs.ndim >= 3
    _, _, _, g1g1, g1g2, g2g2 = _block_ingredients(diffs, length_scale)
    return _assemble(
        [
            [g1g1, g1g2],
            [g1g2, g2g2],
        ]
    )


def shear_Kcross23_fn(diffs: torch.Tensor, length_scale=1.0, **kwargs):
    """Rectangular cross-covariance: (gamma1, gamma2) observations against
    (kappa, gamma1, gamma2) predictions."""
    assert diffs.ndim >= 3
    _, kg1, kg2, g1g1, g1g2, g2g2 = _block_ingredients(diffs, length_scale)
    return _assemble(
        [
            [kg1, g1g1, g1g2],
            [kg2, g1g2, g2g2],
        ]
    )
