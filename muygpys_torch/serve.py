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

The lensing shear family (``ShearKernel``, ``ShearKernel2in3out`` over a
``DifferenceIsotropy``) serves through ``"lanes"`` (the batch-last floored
block Cholesky) or ``"kernel"`` (difference tensors -> shear blocks -> nugget
-> the K5 block solve, :mod:`muygpys_torch.gpu.multiout_solve`) over exact
neighbor indices; ``predict`` then returns mean ``(count, 3)`` and the full
covariance ``(count, 3, 3)``.

Other models served: Matern or RBF kernels over an Isotropy or Anisotropy
deformation, homoscedastic or heteroscedastic noise (pass the
per-training-point ``measurement_noise``).  Any Matern smoothness nu in
``[0.05, 10]`` serves through the kernels: the closed forms by their
formula, any other order through the traced-nu surrogate
(:mod:`muygpys_torch.gpu.matern_nu`), whose coefficients are built once per
server; ``"lanes"`` and ``"reference"`` serve any order through the exact
Bessel path.  The query batch is
padded (``mode="edge"``) up to a fixed bucket.

Under a ``mesh`` (:func:`muygpys_torch.parallel.make_mesh`; every rank of it
builds the server and calls ``predict`` with the same request) each rank
runs on its own device:

- ``shard="queries"`` (the ``"lanes"``, ``"kernel"`` and ``"fused"``
  engines, and the shear engines): each rank serves its ``bucket / size``
  slice of every bucket through the same core, and the outputs are
  all-gathered, so ``predict`` returns the whole answer on every rank;
- ``shard="train"`` (``"fused"`` only): the Morton-sorted training table
  is cut into contiguous row shards.  Each rank searches its shard for every
  query of the bucket (K3 pruned where the shard has >= 1024 rows, else the
  exact search), the candidate rows are all-gathered, each rank merges the
  union exactly for its slice of the queries, solves it through K1, and the
  outputs are all-gathered.

On a CUDA device every engine the JAX package compiles per bucket with
``jax.jit`` (``"fused"``, ``"kernel"`` and the shear ``"kernel"``) is
captured once per server into a CUDA graph
(:class:`muygpys_torch.gpu.graphs.CapturedProgram`), at its first bucket:
a bucket then copies its padded queries (and, for the non-fused engines,
the neighbour indices, looked up outside the graph as in JAX) through a
pinned staging buffer into the graph's static inputs, replays the graph
and copies the outputs back.  No Python runs per kernel, and nothing falls
back: a capture that fails raises.  ``"lanes"`` and ``"reference"``, the
debugging engines, stay eager.  Under a mesh the capture holds the
bucket's collectives too where the backend is NCCL (a group of one issues
none).  Under gloo (ranks sharing one card) the collectives stage through
host memory and cannot be captured, so the server runs its core eagerly:
:attr:`FastServer.mode` says which (``"captured"`` or ``"eager"``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from muygpys_torch import config
from muygpys_torch.gp.deformation import Anisotropy, Isotropy
from muygpys_torch.gp.kernels import Matern, RBF
from muygpys_torch.gp.kernels.experimental import (
    ShearKernel,
    ShearKernel2in3out,
)
from muygpys_torch.gp.kernels.matern import CLOSED_FORMS
from muygpys_torch.gp.muygps import MuyGPS
from muygpys_torch.gp.noise import HeteroscedasticNoise, HomoscedasticNoise
from muygpys_torch.gpu.fused_predict import fused_predict_coords_bl
from muygpys_torch.gpu.graphs import CapturedProgram
from muygpys_torch.gpu.knn import (
    build_index,
    knn_cuda,
    knn_cuda_pruned,
    spatial_sort,
)
from muygpys_torch.gpu.matern_nu import NU_MAX, NU_MIN, matern_nu_coeffs_host
from muygpys_torch.gpu.multiout_solve import multiout_serve_cuda
from muygpys_torch.neighbors import (
    NN_Wrapper,
    _brute_force_knn,
    _train_tiles,
)
from muygpys_torch.ops import tensors as _t
from muygpys_torch.ops.lanes_solver import serve_mean_and_variance_bl
from muygpys_torch.parallel import comm
from muygpys_torch.parallel.mesh import (
    local_chunk_slice,
    mesh_backend,
    mesh_group,
    mesh_index,
    mesh_size,
    rank_device,
)


class FastServer:
    """Batched posterior-serving endpoint for a trained MuyGPS model.

    Args:
        muygps: trained model (Matern/RBF kernel, Isotropy/Anisotropy
            deformation, homoscedastic or heteroscedastic noise; or a shear
            kernel over a DifferenceIsotropy).
        nbrs_lookup: KNN index over the training features.
        train_features / train_targets: the training set (univariate or
            multivariate targets).
        bucket: request size each solve runs at; queries are padded up to
            it.
        engine: ``"fused"`` | ``"kernel"`` (alias ``"pallas"``, the JAX
            name) | ``"lanes"`` | ``"reference"``.
        measurement_noise: per-training-point noise variances
            ``(train_count,)``, required for heteroscedastic models.
        rerank: ``"fused"`` only.  ``True`` over-fetches 8 candidates and
            exactly re-ranks them; ``False`` serves on the kernel's
            ``nn_count`` candidates with 256 bins and 256-query tiles.
        mesh: optional :class:`torch.distributed.device_mesh.DeviceMesh`
            (module docstring); ``bucket`` must divide by its size, and the
            ``"reference"`` engine takes none.
        shard: what the mesh shards, ``"queries"`` (default) or
            ``"train"`` (the ``"fused"`` engine; the training count must
            divide by the mesh size).  Without a mesh it changes nothing.
        spatial_sort: ``"fused"`` only.  Morton-sort the training rows so
            the candidate kernel skips provably irrelevant tiles.  Default
            ``None`` = on when the kernel path runs (>= 1024 training
            points) and the feature dimension is <= 4.
        device: where the server runs (default ``"cuda"``; under a mesh
            this rank's device, :func:`muygpys_torch.parallel.mesh.rank_device`).
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
        self._shear = isinstance(
            muygps.kernel, (ShearKernel, ShearKernel2in3out)
        )
        deformation = muygps.kernel.deformation
        if not self._shear:
            if not isinstance(muygps.kernel, (Matern, RBF)):
                raise ValueError(
                    "FastServer supports Matern/RBF/Shear kernels, not "
                    f"{type(muygps.kernel)}"
                )
            if not isinstance(deformation, (Isotropy, Anisotropy)):
                raise ValueError(
                    "FastServer requires an Isotropy or Anisotropy "
                    f"deformation, not {type(deformation)}"
                )
        engine = config.kernel_alias(engine)
        if engine not in ("fused", "kernel", "lanes", "reference"):
            raise ValueError(f"unknown engine {engine!r}")
        if shard not in ("queries", "train"):
            raise ValueError(f"unknown shard mode {shard!r}")
        if self._shear and engine not in ("lanes", "kernel"):
            raise ValueError(
                "shear models serve via the lanes engine (multi-output "
                "batch-last block solver) or the kernel engine (the fused "
                "block solve)"
            )
        if self._shear and measurement_noise is not None:
            raise ValueError(
                "shear serving does not take per-point measurement noise "
                "(ShearNoise33 is the lensing noise model)"
            )
        if self._shear and shard == "train":
            raise ValueError(
                "shear serving shards queries (shard='train' is a fused-"
                "engine mode)"
            )
        self.mesh = mesh
        self.shard = shard
        self._group = None
        if mesh is not None:
            if engine == "reference":
                raise ValueError(
                    "the reference debug engine does not take a mesh"
                )
            n_dev = mesh_size(mesh)
            if bucket % n_dev:
                raise ValueError(
                    f"bucket {bucket} must divide by the mesh size {n_dev}"
                )
            if shard == "train":
                if engine != "fused":
                    raise ValueError(
                        "shard='train' requires the fused engine (the other"
                        " engines take host-computed global neighbor"
                        " indices)"
                    )
                count = np.asarray(train_features).shape[0]
                if count % n_dev:
                    raise ValueError(
                        f"train_count {count} must divide by the mesh size "
                        f"{n_dev} for shard='train'"
                    )
            self._group = mesh_group(mesh)
            # this rank's slice of every bucket
            lb = bucket // n_dev
            self._slice = slice(mesh_index(mesh) * lb,
                                (mesh_index(mesh) + 1) * lb)
            if device is None:
                device = rank_device()

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

        # the program of one bucket, and whether a card runs it captured
        self._captured = None
        self._capture = (
            self.device.type == "cuda" and engine in ("fused", "kernel")
            and (mesh is None or mesh_backend(mesh) == "nccl")
        )
        if self._shear:
            # multi-output block path: noise, scale and Kout are the model's
            self._core = self._sharded_queries(self._build_shear())
            return

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
        self._gen_coeffs = None
        if engine in ("kernel", "fused"):
            self._smoothness, self._gen_coeffs = self._kernel_smoothness()
        self._core = self._build()
        if not (engine == "fused" and shard == "train"):
            self._core = self._sharded_queries(self._core)

    @property
    def mode(self) -> str:
        """``"captured"`` where a bucket replays a CUDA graph, else
        ``"eager"`` (the CPU, the debugging engines, a gloo mesh)."""
        return "captured" if self._capture else "eager"

    def _sharded_queries(self, core):
        """``core`` under ``shard="queries"``: this rank's slice of the
        bucket (queries, and neighbour indices where the engine takes them),
        then the outputs all-gathered; ``core`` itself without a mesh."""
        if self.mesh is None:
            return core
        sl, group = self._slice, self._group

        def sharded(queries, *nn_idx):
            out = core(queries[sl], *(i[sl] for i in nn_idx))
            return tuple(comm.all_gather(o, group) for o in out)

        return sharded

    def _build_shear(self):
        """Serving program of the lensing shear family: difference tensors
        -> shear covariance blocks -> multi-output block solve -> posterior
        mean ``(B, 3)`` and full covariance ``(B, 3, 3)`` per query.
        Observed targets are 3-component (kappa, gamma1, gamma2) for
        :class:`ShearKernel`, 2-component (gamma1, gamma2) for
        :class:`ShearKernel2in3out`.  ``engine="kernel"`` solves the
        nugget-perturbed blocks through K5 in the layout they are assembled
        in; on a CUDA device it has no other route."""
        muygps, kernel = self.muygps, self.muygps.kernel
        deformation = kernel.deformation
        obs = 2 if isinstance(kernel, ShearKernel2in3out) else 3
        if self._targets.shape[1] != obs:
            raise ValueError(
                f"{type(kernel).__name__} observes {obs} components; "
                f"train_targets has {self._targets.shape[1]}"
            )
        if self.engine == "kernel":
            Kout = kernel.Kout().to(dtype=self._dtype, device=self.device)
            # the scale on the device once: a captured bucket copies nothing
            # from the host
            scale = muygps.scale()
            scale = (scale.to(dtype=self._dtype, device=self.device)
                     if torch.is_tensor(scale) else torch.as_tensor(
                         np.asarray(scale, dtype=float), dtype=self._dtype,
                         device=self.device))

            def solve(Kin, Kcross, nnt):
                mean, cov = multiout_serve_cuda(
                    muygps.noise.perturb(Kin), Kcross, Kout, nnt,
                    device=self.device,
                )
                return mean, scale * cov

        else:
            solve = muygps.posterior_mean_and_variance

        def core(queries, nn_idx):
            pw = deformation.pairwise_tensor(self._train, nn_idx)
            cw = deformation.crosswise_tensor(
                queries, self._train,
                torch.arange(queries.shape[0], device=self.device), nn_idx,
            )
            nnt = self._targets[nn_idx].transpose(-2, -1)  # (B, obs, n)
            return solve(kernel(pw), kernel(cw), nnt)

        return core

    def _kernel_smoothness(self):
        """``(smoothness argument, coefficient vector)`` for K1: a closed
        form compiles to its formula; any other order ships as a
        coefficient vector built ONCE here, on the host in f64, then cast
        (the kernels take it as a runtime input, so one build of them
        serves every general-smoothness model)."""
        nu = self._smoothness
        if nu == "rbf" or nu in CLOSED_FORMS:
            return nu, None
        if not (NU_MIN <= nu <= NU_MAX):
            raise ValueError(
                f"{self.engine} engine serves general Matern smoothness in "
                f"[{NU_MIN}, {NU_MAX}]; got {nu} (use the lanes engine for "
                "exotic orders)"
            )
        if self._metric_power != 1:
            raise ValueError(
                "general-smoothness Matern requires the l2 metric"
            )
        np_dtype = np.float64 if self._dtype == torch.float64 else np.float32
        return "gen", torch.as_tensor(
            matern_nu_coeffs_host(nu, np_dtype), device=self.device
        )

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
            gen_coeffs=self._gen_coeffs, smoothness=self._smoothness,
            metric_power=self._metric_power,
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
        if self.mesh is not None and self.shard == "train":
            return self._train_sharded_core(
                train, table, cand_count, knn_fn, knn_kwargs, spatial
            )
        # the search's train side (padded transpose, norms, tile boxes, the
        # subsample's own), built once: a request computes its query side
        knn_index = (
            build_index(train, bins=knn_kwargs.get("bins", 512), pruned=spatial)
            if use_kernel else None
        )
        tiles = None if use_kernel else _train_tiles(train)

        def core(queries):
            if use_kernel:
                cand, _ = knn_fn(
                    None, queries, cand_count, device=self.device,
                    train_index=knn_index, **knn_kwargs
                )
            else:
                cand, _ = _brute_force_knn(train, queries, cand_count,
                                           tiles=tiles)
            rows = table[cand]  # (B, C, cols)
            if self.rerank:
                d2 = torch.sum((rows[:, :, :d] - queries[:, None, :]) ** 2, -1)
                _, sel = torch.topk(d2, nn_count, dim=1, largest=False)
                rows = torch.gather(
                    rows, 1, sel[:, :, None].expand(-1, -1, rows.shape[2])
                )
            return self._solve_coords(rows, queries)

        return core

    def _train_sharded_core(self, train, table, cand_count, knn_fn,
                            knn_kwargs, spatial):
        """The ``shard="train"`` bucket: candidates over this rank's
        contiguous shard of the (globally sorted) table for every query, the
        candidate rows all-gathered, the exact merge of their union and K1
        on this rank's query slice, the outputs all-gathered."""
        n_dev, group = mesh_size(self.mesh), self._group
        nn_count = self.nbrs.nn_count
        rows = local_chunk_slice(train.shape[0], self.mesh)
        train, table = train[rows].contiguous(), table[rows].contiguous()
        shard_rows = train.shape[0]
        use_kernel = shard_rows >= 1024
        # a shard's candidates cannot exceed its rows; the union merge still
        # needs nn_count candidates in all
        cand_count = min(cand_count, shard_rows)
        if n_dev * cand_count < nn_count:
            raise ValueError(
                f"{n_dev} shards x {cand_count} candidates cannot cover "
                f"nn_count={nn_count}"
            )
        knn_index = (
            build_index(train, bins=knn_kwargs.get("bins", 512),
                        pruned=spatial)
            if use_kernel else None
        )
        tiles = None if use_kernel else _train_tiles(train)
        d, sl = train.shape[1], self._slice

        def core(queries):
            if use_kernel:
                cand, _ = knn_fn(
                    None, queries, cand_count, device=self.device,
                    train_index=knn_index, **knn_kwargs
                )
            else:
                cand, _ = _brute_force_knn(train, queries, cand_count,
                                           tiles=tiles)
            # every shard's candidate rows: (n_dev, B, C, cols) -> (B, n_dev
            # C, cols); the coordinates ride in the rows
            union = comm.all_gather(table[cand][None], group)
            union = union.transpose(0, 1).reshape(
                queries.shape[0], n_dev * cand_count, table.shape[1]
            )[sl]
            q = queries[sl]
            d2 = torch.sum((union[:, :, :d] - q[:, None, :]) ** 2, -1)
            _, sel = torch.topk(d2, nn_count, dim=1, largest=False)
            mine = torch.gather(
                union, 1, sel[:, :, None].expand(-1, -1, union.shape[2])
            )
            return tuple(comm.all_gather(o, group)
                         for o in self._solve_coords(mine, q))

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
        kernel_fn = self.muygps.kernel.of_scaled_dists
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
        of queries of any size; a shear model returns mean ``(count, 3)``
        and covariance ``(count, 3, 3)``."""
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
            arrays = [chunk]
            if not fused:
                idx = nn_idx[start:start + self.bucket]
                if pad:
                    idx = np.pad(idx, ((0, pad), (0, 0)), mode="edge")
                arrays.append(idx)
            if self._capture:
                m, v = self._replay(arrays)
            else:
                m, v = self._core(
                    torch.as_tensor(chunk, dtype=self._dtype,
                                    device=self.device),
                    *(torch.as_tensor(a, device=self.device)
                      for a in arrays[1:]),
                )
            means.append(m.cpu().numpy())
            variances.append(v.cpu().numpy())
        return np.concatenate(means)[:count], np.concatenate(variances)[:count]

    def _replay(self, arrays):
        """One bucket through the captured program: the padded queries (and
        neighbour indices) via pinned staging buffers into its static
        inputs, then a replay.  The first bucket captures it."""
        np_dtype = np.float64 if self._dtype == torch.float64 else np.float32
        arrays = [np.ascontiguousarray(arrays[0], dtype=np_dtype)] + [
            np.ascontiguousarray(a, dtype=np.int64) for a in arrays[1:]
        ]
        if self._captured is None:
            self._staging = [
                torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                            pin_memory=True) for a in arrays
            ]
            inputs = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                      for h in self._staging]
        else:
            inputs = self._captured.inputs
        for host, dev, a in zip(self._staging, inputs, arrays):
            host.copy_(torch.from_numpy(a))
            dev.copy_(host, non_blocking=True)
        if self._captured is None:
            self._captured = CapturedProgram(self._core, inputs)
        return self._captured.replay()
