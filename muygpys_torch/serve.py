"""Production serving: trained model -> batched posterior endpoint.

Counterpart of :class:`muygpys_tpu.serve.FastServer`.  Engines:

- ``"fused"``: everything on the device per bucket — the K3 candidate
  kernel (:mod:`muygpys_torch.gpu.knn`) over the training set (Morton-sorted
  and pruned at ``d <= 4``), ONE gather of a packed ``[features | targets
  (| noise)]`` table, exact re-rank of the over-fetched candidates, then the
  K1 coords solve (:mod:`muygpys_torch.gpu.fused_predict`).  The KNN index
  passed in is used only for its ``nn_count``.
- ``"kernel"`` (JAX: ``"pallas"``): exact neighbor indices from the
  ``NN_Wrapper``, then the K1 coords solve.
- ``"lanes"``: plain PyTorch batch-last assembly and the floored Cholesky
  of :mod:`muygpys_torch.ops.lanes_solver`.
- ``"reference"``: the generic standard-layout path (debugging;
  homoscedastic models only).

Models served: Matern (closed-form smoothness) or RBF kernels over an
Isotropy or Anisotropy deformation, homoscedastic or heteroscedastic noise
(pass the per-training-point ``measurement_noise``).  The query batch is
padded (``mode="edge"``) up to a fixed bucket.  ``mesh``/``shard`` and the
shear models are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp.deformation import Anisotropy, Isotropy
from muygpys_torch.gp.kernels import Matern, RBF
from muygpys_torch.gp.muygps import MuyGPS
from muygpys_torch.gp.noise import HeteroscedasticNoise, HomoscedasticNoise
from muygpys_torch.gpu.fused_predict import fused_predict_coords_bl
from muygpys_torch.gpu.knn import knn_cuda, knn_cuda_pruned, spatial_sort
from muygpys_torch.neighbors import NN_Wrapper, _brute_force_knn
from muygpys_torch.ops import tensors as _t
from muygpys_torch.ops.lanes_solver import serve_mean_and_variance_bl


class FastServer:
    """Batched posterior-serving endpoint for a trained MuyGPS model.

    Args:
        muygps: trained model (Matern/RBF kernel, Isotropy/Anisotropy
            deformation, homoscedastic or heteroscedastic noise).
        nbrs_lookup: KNN index over the training features.
        train_features / train_targets: the training set (univariate or
            multivariate targets).
        bucket: request size each solve runs at; queries are padded up to
            it.
        engine: ``"fused"`` | ``"kernel"`` | ``"lanes"`` | ``"reference"``.
        measurement_noise: per-training-point noise variances
            ``(train_count,)``, required for heteroscedastic models.
        rerank: ``"fused"`` only.  ``True`` over-fetches 8 candidates and
            exactly re-ranks them; ``False`` serves on the kernel's
            ``nn_count`` candidates with 256 bins and 256-query tiles.
        spatial_sort: ``"fused"`` only.  Morton-sort the training rows so
            the candidate kernel skips provably irrelevant tiles.  Default
            ``None`` = on when the kernel path runs (>= 1024 training
            points) and the feature dimension is <= 4.
        device: where the server runs (default ``"cuda"``).
    """

    def __init__(
        self,
        muygps: MuyGPS,
        nbrs_lookup: NN_Wrapper,
        train_features,
        train_targets,
        bucket: int = 4096,
        engine: str = "lanes",
        measurement_noise=None,
        rerank: bool = True,
        mesh=None,
        shard: str = "queries",
        spatial_sort: Optional[bool] = None,
        device=None,
    ):
        if mesh is not None or shard != "queries":
            raise NotImplementedError(
                "multi-device serving (mesh/shard) is not ported yet"
            )
        if not isinstance(muygps.kernel, (Matern, RBF)):
            raise NotImplementedError(
                f"serving {type(muygps.kernel).__name__} is not ported yet "
                "(Matern and RBF only)"
            )
        deformation = muygps.kernel.deformation
        if not isinstance(deformation, (Isotropy, Anisotropy)):
            raise ValueError(
                "FastServer requires an Isotropy or Anisotropy deformation, "
                f"not {type(deformation)}"
            )
        if engine not in ("fused", "kernel", "lanes", "reference"):
            raise ValueError(f"unknown engine {engine!r}")

        self.device = config.device(device)
        self.muygps = muygps
        self.nbrs = nbrs_lookup
        self.bucket = bucket
        self.engine = engine
        self.rerank = rerank
        self.spatial_sort = spatial_sort
        self._dtype = config.ftype()
        train = np.asarray(train_features)
        if train.ndim == 1:
            train = train[:, None]
        targets = np.asarray(train_targets)
        if targets.ndim == 1:
            targets = targets[:, None]
        self._train = torch.as_tensor(
            train, dtype=self._dtype, device=self.device
        )
        self._targets = torch.as_tensor(
            targets, dtype=self._dtype, device=self.device
        )
        feature_count = train.shape[1]

        if isinstance(muygps.noise, HeteroscedasticNoise):
            if measurement_noise is None:
                raise ValueError(
                    "heteroscedastic serving requires the per-training-point "
                    "measurement_noise vector"
                )
            eps = np.asarray(measurement_noise).reshape(-1)
            if eps.shape[0] != train.shape[0]:
                raise ValueError(
                    f"measurement_noise has {eps.shape[0]} entries for "
                    f"{train.shape[0]} training points"
                )
            self._meas = torch.as_tensor(
                eps, dtype=self._dtype, device=self.device
            )
            self._noise = 0.0
        elif isinstance(muygps.noise, HomoscedasticNoise):
            self._meas = None
            self._noise = float(muygps.noise())
        else:
            raise ValueError(
                f"FastServer does not support noise {type(muygps.noise)}"
            )
        if engine == "reference" and self._meas is not None:
            raise ValueError(
                "the reference engine serves homoscedastic models only"
            )

        # length scales, one per feature (isotropy replicates its scalar)
        ls = np.asarray(deformation.length_scale(), float).reshape(-1)
        if isinstance(deformation, Anisotropy):
            if ls.shape[0] != feature_count:
                raise ValueError(
                    f"{ls.shape[0]} anisotropic length scales for "
                    f"{feature_count} features"
                )
            self._ls_vec = ls
        else:
            self._ls_vec = np.full(feature_count, float(ls[0]))
        self._scale = float(np.asarray(muygps.scale()).reshape(-1)[0])
        self._smoothness = (
            "rbf" if isinstance(muygps.kernel, RBF)
            else float(muygps.kernel.smoothness())
        )
        self._metric_power = 2 if deformation.metric.name == "F2" else 1
        self._predict_fn = self._build()

    def _build(self):
        if self.engine == "reference":
            return self._reference_core
        if self.engine == "lanes":
            return self._lanes_core
        self._params = torch.as_tensor(
            list(self._ls_vec) + [self._noise], dtype=self._dtype,
            device=self.device,
        )
        if self.engine == "kernel":
            return self._kernel_core
        return self._build_fused()

    # -- engines: (queries (B, d)[, nn_idx (B, n)]) -> mean (B, r), var (B,)

    def _solve_coords(self, rows, queries):
        """K1 on gathered ``[features | targets (| noise)]`` rows
        ``(B, n, cols)``."""
        d = self._train.shape[1]
        r = self._targets.shape[1]
        nf = rows[:, :, :d].permute(1, 2, 0)  # (n, d, B)
        y = rows[:, :, d:d + r].permute(1, 2, 0)  # (n, r, B)
        noise_nn = None if self._meas is None else rows[:, :, d + r].T
        mean, var = fused_predict_coords_bl(
            nf, queries.T, y, self._params, noise_nn=noise_nn,
            smoothness=self._smoothness, metric_power=self._metric_power,
            device=self.device,
        )
        return mean.T, self._scale * var

    def _kernel_core(self, queries, nn_idx):
        cols = [self._train, self._targets]
        if self._meas is not None:
            cols.append(self._meas[:, None])
        rows = torch.cat([c[nn_idx] for c in cols], dim=-1)
        return self._solve_coords(rows, queries)

    def _build_fused(self):
        train, targets, meas = self._train, self._targets, self._meas
        nn_count = self.nbrs.nn_count
        # below 2*bins=1024 train rows the packed-key kernel cannot fill every
        # candidate slot with a distinct real column, and exact brute force
        # is faster at that scale anyway
        use_kernel = train.shape[0] >= 1024
        spatial = self.spatial_sort
        if spatial is None:
            spatial = use_kernel and train.shape[1] <= 4
        if spatial and not use_kernel:
            raise ValueError(
                "spatial_sort requires the candidate kernel "
                "(>= 1024 training points)"
            )
        if spatial:
            perm = spatial_sort(train)
            train, targets = train[perm], targets[perm]
            if meas is not None:
                meas = meas[perm]
        self._spatial = bool(spatial)
        # one packed table -> ONE row gather per query batch
        cols = [train, targets] + ([] if meas is None else [meas[:, None]])
        table = torch.cat(cols, dim=1)
        d = train.shape[1]
        # +8 over-fetch with exact re-rank; without re-rank the kernel's
        # nn_count candidates are the neighborhood, at 256 bins / 256-query
        # tiles (the JAX package's tuned approximate-mode geometry)
        cand_count = (
            min(nn_count + 8, train.shape[0]) if self.rerank else nn_count
        )
        knn_kwargs = {} if self.rerank else {"bins": 256, "query_tile": 256}
        knn_fn = knn_cuda_pruned if spatial else knn_cuda

        def core(queries):
            if use_kernel:
                cand, _ = knn_fn(
                    train, queries, cand_count, device=self.device, **knn_kwargs
                )
            else:
                cand, _ = _brute_force_knn(train, queries, cand_count)
            rows = table[cand]  # (B, C, cols)
            if self.rerank:
                d2 = torch.sum((rows[:, :, :d] - queries[:, None, :]) ** 2, -1)
                _, sel = torch.topk(d2, nn_count, dim=1, largest=False)
                rows = torch.gather(
                    rows, 1, sel[:, :, None].expand(-1, -1, rows.shape[2])
                )
            return self._solve_coords(rows, queries)

        return core

    def _lanes_core(self, queries, nn_idx):
        # batch-last scaled-distance assembly straight from gathers; the
        # per-feature pre-scaling makes anisotropy the isotropic ls=1 case
        inv_ls = torch.as_tensor(
            1.0 / self._ls_vec, dtype=self._dtype, device=self.device
        )
        nf = self._train[nn_idx] * inv_ls  # (B, n, f)
        q = queries * inv_ls  # (B, f)
        sq = torch.sum(nf * nf, -1)
        d2p = torch.clamp_min(
            sq[:, :, None] + sq[:, None, :] - 2.0 * (nf @ nf.transpose(1, 2)),
            0.0,
        )
        d2c = torch.clamp_min(
            torch.sum(q * q, -1)[:, None] + sq
            - 2.0 * torch.einsum("bf,bnf->bn", q, nf),
            0.0,
        )
        if self._metric_power == 1:
            d2p, d2c = _t.safe_sqrt(d2p), _t.safe_sqrt(d2c)
        pw, cw = d2p.permute(1, 2, 0), d2c.T
        y = self._targets[nn_idx].permute(1, 2, 0)  # (n, r, B)
        n = pw.shape[0]
        eye = torch.eye(n, dtype=pw.dtype, device=pw.device)[:, :, None]
        kernel_fn = self.muygps.kernel._kernel_fn
        if self._meas is None:
            Kin = kernel_fn(pw) + self._noise * eye
        else:
            Kin = kernel_fn(pw) + eye * self._meas[nn_idx].T[:, None, :]
        mean, var = serve_mean_and_variance_bl(Kin, kernel_fn(cw), 1.0, y)
        return mean.T, self._scale * var

    def _reference_core(self, queries, nn_idx):
        crosswise, pairwise, nn_targets = self.muygps.make_predict_tensors(
            torch.arange(queries.shape[0], device=self.device), nn_idx,
            queries, self._train, self._targets,
        )
        Kin = self.muygps.kernel(pairwise)
        Kcross = self.muygps.kernel(crosswise)
        return self.muygps.posterior_mean_and_variance(Kin, Kcross, nn_targets)

    def predict(self, test_features) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior (mean ``(count, r)``, variance ``(count,)``) for a batch
        of queries of any size."""
        test = np.asarray(test_features)
        if test.ndim == 1:
            test = test[:, None]
        count = test.shape[0]
        fused = self.engine == "fused"
        nn_idx = None if fused else np.asarray(self.nbrs.get_nns(test)[0])
        means, variances = [], []
        for start in range(0, count, self.bucket):
            chunk = test[start:start + self.bucket]
            pad = self.bucket - chunk.shape[0]
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)), mode="edge")
            queries = torch.as_tensor(
                chunk, dtype=self._dtype, device=self.device
            )
            if fused:
                m, v = self._predict_fn(queries)
            else:
                idx = nn_idx[start:start + self.bucket]
                if pad:
                    idx = np.pad(idx, ((0, pad), (0, 0)), mode="edge")
                m, v = self._predict_fn(
                    queries, torch.as_tensor(idx, device=self.device)
                )
            means.append(m.cpu().numpy())
            variances.append(v.cpu().numpy())
        return np.concatenate(means)[:count], np.concatenate(variances)[:count]
