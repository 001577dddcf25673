"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: K1 :mod:`muygpys_torch.gpu.fused_predict`, K2
:mod:`muygpys_torch.gpu.fused_train`, K3 :mod:`muygpys_torch.gpu.knn`, K4
:mod:`muygpys_torch.gpu.matern_nu`, K5 :mod:`muygpys_torch.gpu.multiout_solve`.
Built on first use by :mod:`muygpys_torch.gpu._build`."""
