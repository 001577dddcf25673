"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: K1 :mod:`muygpys_torch.gpu.fused_predict`, K3
:mod:`muygpys_torch.gpu.knn`.  Built on first use by
:mod:`muygpys_torch.gpu._build`."""
