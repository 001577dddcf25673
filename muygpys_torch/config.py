"""Runtime configuration: float width, index type, command-line flags and
device selection.

Environment variables (read once at import):

- ``MUYGPYS_FTYPE``: ``"32"`` (default, the serving type) or ``"64"``
  (conformance testing), as in :mod:`muygpys_tpu.config`.

Distance products run in full float32: TF32 is switched off for matrix
products and convolutions at import (PyTorch's cuDNN default is TF32, which
keeps about three decimal digits and scrambles neighbor ranking — the JAX
package runs every distance product at ``Precision.HIGHEST`` for the same
reason).
"""

from __future__ import annotations

import dataclasses
import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _env_ftype() -> int:
    val = os.environ.get("MUYGPYS_FTYPE", "32").strip()
    if val not in ("32", "64"):
        raise ValueError(f"MUYGPYS_FTYPE must be '32' or '64', got {val!r}")
    return int(val)


@dataclasses.dataclass
class _State:
    ftype: int = 32


state = _State(ftype=_env_ftype())


def update(key: str, value) -> None:
    """Programmatic config update, e.g. ``config.update("ftype", 64)``."""
    if key in ("ftype", "muygpys_ftype"):
        value = int(value)
        if value not in (32, 64):
            raise ValueError(f"ftype must be 32 or 64, got {value}")
        state.ftype = value
    else:
        raise ValueError(f"unknown config key {key!r}")


def ftype() -> torch.dtype:
    """The current default float dtype."""
    return torch.float64 if state.ftype == 64 else torch.float32


def itype() -> torch.dtype:
    """The index dtype of :mod:`muygpys_tpu.config` (``int32``).  The
    port's own gathers take ``int64`` indices, PyTorch's gather type."""
    return torch.int32


def parse_flags(argv=None):
    """Consume ``--muygpys_*`` command-line flags; returns the remaining
    arguments.

    Recognized: ``--muygpys_ftype={32,64}``, as in
    :func:`muygpys_tpu.config.parse_flags`; any other ``--muygpys_`` flag
    raises.  ``argv`` defaults to ``sys.argv[1:]``.
    """
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    remaining = []
    for arg in args:
        if arg.startswith("--muygpys_ftype"):
            val = arg.split("=", 1)[1] if "=" in arg else None
            if val is None:
                raise ValueError("--muygpys_ftype requires =32 or =64")
            update("ftype", val)
        elif arg.startswith("--muygpys_"):
            raise ValueError(f"unknown flag {arg.split('=')[0]!r}")
        else:
            remaining.append(arg)
    return remaining


def kernel_alias(name: str) -> str:
    """An engine or ``nn_method`` name with the JAX package's ``"pallas"``
    read as the port's ``"kernel"`` (the hand-written CUDA kernels), so a
    JAX script's arguments run unchanged."""
    return "kernel" if name == "pallas" else name


def device(device=None) -> torch.device:
    """Resolve an entry point's ``device=`` argument.

    ``None`` means ``"cuda"``.  A CUDA device without a card raises: the
    port never falls back to the CPU unless the caller asks for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "muygpys_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU"
        )
    return dev
