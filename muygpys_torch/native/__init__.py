"""Native (C++) host-side components: the HNSW approximate nearest-neighbor
index (:mod:`muygpys_torch.native.hnsw`), compiled with ``g++`` on first
use into ``build/muygpys_torch/``."""

from muygpys_torch.native.hnsw import HNSW

__all__ = ["HNSW"]
