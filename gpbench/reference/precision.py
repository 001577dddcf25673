"""The precision the reference computes in: float64 for the judgement,
and the control's "the nearest precision below the configuration's"
(float32 with TF32 matrix products switched on, where the program runs
float32 with TF32 off)."""

from __future__ import annotations

import contextlib


def matmul_operand(t):
    """A matrix product's operand as the product will read it: under TF32
    (``torch.backends.cuda.matmul.allow_tf32``) a float32 operand rounded
    to TF32's 10 explicit mantissa bits, to nearest, as the tensor cores
    read it.  The rounding is written out because the library takes the
    flag as a permission: at some shapes (the distance products of 2-D
    points, whose inner dimension is 2) it runs plain float32 kernels."""
    import torch

    if t.dtype != torch.float32 or not torch.backends.cuda.matmul.allow_tf32:
        return t
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


@contextlib.contextmanager
def computing(precision: str):
    """``"float64"`` or ``"tf32"``: yields the dtype, with TF32 products
    allowed only under ``"tf32"``."""
    import torch

    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float32 if tf32 else torch.float64
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
