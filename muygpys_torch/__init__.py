"""muygpys_torch: MuyGPs serving in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of :mod:`muygpys_tpu`, written for an NVIDIA
Hopper (H100) card.  Module and public names follow the JAX package so each
piece has a findable counterpart; the code runs eagerly (no ``jit``), a batch
dimension replaces ``vmap`` and Python loops replace unrolled JAX loops.

Entry points (:class:`muygpys_torch.serve.FastServer`,
:class:`muygpys_torch.neighbors.NN_Wrapper`, the kernel wrappers under
:mod:`muygpys_torch.gpu`) run on ``"cuda"`` unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of falling back.

Importing the package compiles nothing: the CUDA sources under
``muygpys_torch/gpu/csrc`` are built with ``nvcc``, and the HNSW index's
``muygpys_torch/native/hnsw.cpp`` with ``g++``, on first use.
"""

from muygpys_torch import config

__version__ = "0.1.0"

__all__ = ["config", "__version__"]
