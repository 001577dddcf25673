"""Noise (nugget) perturbations of in-neighborhood covariance tensors.

Counterpart of :mod:`muygpys_tpu.ops.noise`: ``homoscedastic_perturb``,
``heteroscedastic_perturb`` and ``shear_perturb33``, each returning a new
tensor (no in-place update, so a proposed ``noise`` that requires grad stays
in the autograd graph).  The noise models of :mod:`muygpys_torch.gp.noise`
call these.
"""

from __future__ import annotations

import torch


def _eye(count: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(count, dtype=ref.dtype, device=ref.device)


def homoscedastic_perturb(Kin: torch.Tensor, noise_variance) -> torch.Tensor:
    """Add ``tau^2 I`` to each neighborhood covariance block: ``Kin (batch,
    nn, nn)``, or the flattened ``(in * nn, in * nn)`` blocks of the
    multi-output layout ``(batch, in, nn, in, nn)``."""
    if Kin.ndim == 3:
        return Kin + noise_variance * _eye(Kin.shape[-1], Kin)
    if Kin.ndim == 5:
        b, in_count, nn_count, in2, nn2 = Kin.shape
        if (in_count, nn_count) != (in2, nn2):
            raise ValueError(
                "homoscedastic perturbation takes (b, in, nn, in, nn), got "
                f"{tuple(Kin.shape)}"
            )
        all_count = in_count * nn_count
        flat = Kin.reshape(b, all_count, all_count) + noise_variance * _eye(
            all_count, Kin
        )
        return flat.reshape(Kin.shape)
    raise ValueError(
        "homoscedastic perturbation not implemented for shape "
        f"{tuple(Kin.shape)}"
    )


def heteroscedastic_perturb(
    Kin: torch.Tensor, noise_variances: torch.Tensor
) -> torch.Tensor:
    """Add per-neighbor diagonal noise: ``Kin[b] + diag(noise[b])``."""
    noise = torch.as_tensor(noise_variances).to(
        dtype=Kin.dtype, device=Kin.device
    )
    return Kin + noise[..., :, None] * _eye(Kin.shape[-1], Kin)


def shear_perturb33(Kin: torch.Tensor, noise_variance) -> torch.Tensor:
    """``Kin (batch, 3, nn, 3, nn)`` with ``2 tau^2`` added to the diagonal
    of the first (convergence) block and ``tau^2`` to the two shear
    blocks'."""
    if Kin.ndim != 5 or Kin.shape[1] != 3 or Kin.shape[3] != 3:
        raise ValueError(
            "shear perturbation requires (b, 3, nn, 3, nn), got "
            f"{tuple(Kin.shape)}"
        )
    b, in_count, nn_count, _, _ = Kin.shape
    all_count = in_count * nn_count
    ones = torch.ones(nn_count, dtype=Kin.dtype, device=Kin.device)
    diag = torch.cat(
        [2.0 * noise_variance * ones, noise_variance * ones.repeat(2)]
    )
    flat = Kin.reshape(b, all_count, all_count) + torch.diag(diag)
    return flat.reshape(Kin.shape)
