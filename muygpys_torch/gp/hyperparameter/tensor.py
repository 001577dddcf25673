"""Tensor-valued (always fixed) hyperparameters.

Counterpart of :class:`muygpys_tpu.gp.hyperparameter.TensorParam`; it holds
heteroscedastic measurement noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class TensorParam:
    """An array-valued hyperparameter.  Never optimized."""

    def __init__(self, val):
        self._set_val(val)

    def _set_val(self, val) -> None:
        if isinstance(val, str):
            raise ValueError("TensorParam does not support strings")
        if not isinstance(val, (np.ndarray, torch.Tensor)):
            raise ValueError(
                f"non-array tensor hyperparameter type {type(val)} is not "
                "allowed"
            )
        if isinstance(val, np.ndarray):
            val = np.array(val)  # a writable copy of a read-only view
        self._val = torch.as_tensor(val)

    def _set(self, val=None) -> None:
        if val is not None:
            self._set_val(val)

    def __call__(self) -> torch.Tensor:
        return self._val

    def fixed(self) -> bool:
        return True

    def append_lists(self, names, params, bounds) -> None:
        """Tensor parameters are never on the optimization surface."""

    def get_bounds(self) -> Tuple[float, float]:
        raise NotImplementedError(
            "TensorParam does not support optimization bounds"
        )
