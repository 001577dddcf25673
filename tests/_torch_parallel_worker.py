"""Rank processes of the port's sharded-path tests.

:func:`spawn` starts a ``torch.distributed`` world of gloo ranks on the
CPU (``torch.multiprocessing.spawn``), brought up through the port's
:func:`muygpys_torch.parallel.initialize_distributed`; every rank runs one
named case function of this module on the same payload (numpy arrays made by
the parent from a seed) and returns a dict, which the parent receives per
rank.  The ranks import torch, numpy and the port, never JAX: the parent
computes the JAX side and compares.
"""

import os
import pickle
import socket
import sys
import tempfile

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, case, in_path, out_dir):
    import torch

    torch.set_num_threads(1)
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    import torch.distributed as dist

    from muygpys_torch.parallel import initialize_distributed

    assert initialize_distributed(
        device="cpu", coordinator_address=f"localhost:{port}",
        num_processes=world, process_id=rank,
    )
    with open(in_path, "rb") as f:
        payload = pickle.load(f)
    out = globals()[case](rank, world, payload)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


class World:
    """A world of ``size`` gloo ranks, each running ``case(rank, size,
    payload)``, started at construction; :meth:`results` waits for it and
    returns the ranks' dicts in rank order.  The parent works meanwhile."""

    def __init__(self, case: str, size: int, payload):
        import torch.multiprocessing as mp

        self._tmp = tempfile.TemporaryDirectory()
        in_path = os.path.join(self._tmp.name, "payload.pkl")
        with open(in_path, "wb") as f:
            pickle.dump(payload, f)
        self.size = size
        self._ctx = mp.spawn(
            _entry, args=(size, _free_port(), case, in_path, self._tmp.name),
            nprocs=size, join=False,
        )
        self._results = None

    def results(self) -> list:
        if self._results is None:
            while not self._ctx.join():
                pass
            self._results = []
            for r in range(self.size):
                path = os.path.join(self._tmp.name, f"rank{r}.pkl")
                with open(path, "rb") as f:
                    self._results.append(pickle.load(f))
            self._tmp.cleanup()
        return self._results


def spawn(case: str, world: int, payload) -> list:
    """Run ``case(rank, world, payload)`` on ``world`` gloo ranks; returns
    the ranks' dicts in rank order."""
    return World(case, world, payload).results()


# -- models of the port, built from the payload's arrays ---------------------


def matern_model(ls=0.3, ls_bounds=(0.01, 1.0), noise=1e-3, scale="analytic",
                 nu=1.5, noise_bounds="fixed"):
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import (
        AnalyticScale,
        FixedScale,
        Parameter,
    )
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise

    if scale == "analytic":
        sc = AnalyticScale()
    else:
        sc = FixedScale()
        sc._set(scale)
    return MuyGPS(
        kernel=Matern(
            smoothness=Parameter(nu),
            deformation=Isotropy(l2, length_scale=Parameter(ls, ls_bounds)),
        ),
        noise=HomoscedasticNoise(noise, noise_bounds),
        scale=sc,
    )


def shear_model(ls, bounds="fixed", noise=1e-4):
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import F2, DifferenceIsotropy
    from muygpys_torch.gp.hyperparameter import FixedScale, Parameter
    from muygpys_torch.gp.kernels.experimental import ShearKernel
    from muygpys_torch.gp.noise import ShearNoise33

    return MuyGPS(
        kernel=ShearKernel(
            deformation=DifferenceIsotropy(
                F2, length_scale=Parameter(ls, bounds)
            )
        ),
        noise=ShearNoise33(noise),
        scale=FixedScale(),
    )


def train_tensors(model, p, batch=None):
    """``(cw, pw, bt, bnt)`` of the payload's batch (its first ``batch``
    rows)."""
    import torch

    bi, bni = p["bi"], p["bni"]
    if batch is not None:
        bi, bni = bi[:batch], bni[:batch]
    return model.make_train_tensors(
        bi, bni, torch.as_tensor(p["xtr"]), torch.as_tensor(p["ytr"])
    )


def shear_tensors(model, p):
    import torch

    pts = torch.as_tensor(p["pts"])
    bni = torch.as_tensor(p["shear_bni"])
    bi = torch.arange(pts.shape[0])
    deformation = model.kernel.deformation
    pw = deformation.pairwise_tensor(pts, bni)
    cw = deformation.crosswise_tensor(pts, pts, bi, bni)
    bt = torch.as_tensor(p["shear_targets"])
    bnt = torch.as_tensor(p["shear_targets"][p["shear_bni"]]).transpose(-2,
                                                                        -1)
    return cw, pw, bt, bnt


def value_and_grad(obj, name, at):
    import torch

    x = torch.tensor(at, dtype=torch.float64, requires_grad=True)
    val = obj(**{name: x})
    (g,) = torch.autograd.grad(val, x)
    return float(val), float(g)


# -- the cases of tests/test_distributed.py ---------------------------------


def distributed_cases(rank, world, p):
    """Every sharded case of the JAX package's distributed tests, through
    the port's sharded entry points; returns the values the parent checks
    (gathered outputs are whole on every rank)."""
    import torch

    from muygpys_torch.gp.noise import HeteroscedasticNoise
    from muygpys_torch.ops import solve as solve_ops
    from muygpys_torch.optimize import (
        Fused_L_BFGS_B_optimize,
        L_BFGS_B_optimize,
        looph_fn,
        lool_fn,
        mse_fn,
    )
    from muygpys_torch.optimize.fused_objective import (
        make_fused_train_objective,
    )
    from muygpys_torch.optimize.shear_objective import (
        make_shear_loo_objective,
    )
    from muygpys_torch.parallel import (
        gather_global,
        local_chunk_slice,
        make_mesh,
        shard,
        shard_batch,
        shard_ragged,
        shard_ragged_global,
        sharded_knn,
    )
    from muygpys_torch.parallel.sharding import shard_map
    from torch.distributed.tensor import DTensor

    out = {}
    mesh = make_mesh()
    model = matern_model()
    cw, pw, bt, bnt = train_tensors(model, p)
    cw_s, pw_s, bt_s, bnt_s = shard_batch((cw, pw, bt, bnt), mesh)
    out["local_rows"] = int(cw_s.to_local().shape[0])

    obj = L_BFGS_B_optimize.make_obj_fn(model, bt_s, bnt_s, cw_s, pw_s,
                                        loss_fn=lool_fn)
    out["obj"], out["grad"] = value_and_grad(obj, "length_scale", 0.07)
    out["obj_float"] = float(obj(length_scale=0.07))

    for name, loss_fn in [("lool", lool_fn), ("mse", mse_fn),
                          ("looph", looph_fn)]:
        rag = tuple(t[:77] for t in (cw, pw, bt, bnt))
        (cw_r, pw_r, bt_r, bnt_r), w = shard_ragged(rag, mesh)
        out["ragged_rows"] = int(cw_r.shape[0])
        out["ragged_weight"] = float(w.full_tensor().sum())
        obj_r = L_BFGS_B_optimize.make_obj_fn(
            model, bt_r, bnt_r, cw_r, pw_r, loss_fn=loss_fn,
            loss_kwargs={"row_weights": w},
        )
        out[f"ragged_{name}"] = value_and_grad(obj_r, "length_scale", 0.07)

    def predict(cw_, pw_, bnt_):
        Kin_, Kcross_ = model.kernel(pw_), model.kernel(cw_)
        return (model.posterior_mean(Kin_, Kcross_, bnt_),
                model.posterior_variance(Kin_, Kcross_))

    mean_sh, var_sh = shard_map(predict)(cw_s, pw_s, bnt_s)
    out["posterior_sharded"] = bool(
        isinstance(mean_sh, DTensor)
        and mean_sh.to_local().shape[0] == bt.shape[0] // world
    )
    out["mean"] = gather_global(mean_sh)
    out["var"] = gather_global(var_sh)

    model.optimize_scale(pw, bnt)
    opt_fn = model.scale.get_opt_fn(model)
    out["scale"] = float(shard_map(
        lambda p_, y_: opt_fn(model.kernel(p_), y_), out_specs="replicate"
    )(pw_s, bnt_s))

    opt = L_BFGS_B_optimize(model, bt_s, bnt_s, cw_s, pw_s, loss_fn=lool_fn)
    out["opt_ls"] = float(opt.kernel.deformation.length_scale())

    # sharded exact KNN, and its refusal of a ragged train count
    idx, d2 = sharded_knn(shard(p["knn_train"], mesh),
                          torch.as_tensor(p["knn_queries"]), 12, mesh)
    out["knn_idx"], out["knn_d2"] = idx.numpy(), d2.numpy()
    try:
        sharded_knn(torch.as_tensor(p["knn_train"][:1001, :3]),
                    torch.as_tensor(p["knn_train"][:5, :3]), 4, mesh)
        out["knn_ragged"] = ""
    except ValueError as err:
        out["knn_ragged"] = str(err)

    # heteroscedastic noise and the fast mean's precompute and contraction
    Kin_h, Kcross_h, y_h, noise_h = (
        torch.as_tensor(p[k]) for k in ("Kin_h", "Kcross_h", "y_h",
                                        "noise_h")
    )

    def fast_pipeline(Kin_, Kcross_, y_, noise_):
        coeffs = solve_ops.fast_posterior_mean_precompute(
            HeteroscedasticNoise(noise_).perturb(Kin_), y_
        )
        return coeffs, solve_ops.fast_posterior_mean(Kcross_, coeffs)

    coeffs_sh, fast_sh = shard_map(fast_pipeline)(
        *shard_batch((Kin_h, Kcross_h, y_h, noise_h), mesh)
    )
    out["fast_sharded"] = bool(isinstance(fast_sh, DTensor))
    out["coeffs"] = gather_global(coeffs_sh)
    out["fast"] = gather_global(fast_sh)

    # the shear family: the generic objective, the shear assembly, the
    # posterior
    smodel = shear_model(0.15, (0.02, 0.5))
    scw, spw, sbt, sbnt = shear_tensors(smodel, p)
    ss = shard_batch((scw, spw, sbt, sbnt), mesh)
    sobj = L_BFGS_B_optimize.make_obj_fn(smodel, ss[2], ss[3], ss[0], ss[1],
                                         loss_fn=mse_fn)
    out["shear_generic"] = value_and_grad(sobj, "length_scale", 0.1)
    for loss in ("mse", "lool"):
        fobj, _ = make_shear_loo_objective(
            smodel, ss[2], ss[3], ss[0], ss[1], loss=loss, layout="batched",
            device="cpu",
        )
        out[f"shear_{loss}"] = value_and_grad(
            lambda length_scale: fobj({"length_scale": length_scale}),
            "length_scale", 0.1,
        )
    pmodel = shear_model(0.12)
    out["shear_posterior"] = gather_global(shard_map(
        lambda c, w_, y: pmodel.posterior_mean(pmodel.kernel(w_),
                                               pmodel.kernel(c), y)
    )(ss[0], ss[1], ss[3]))

    # K2 (its plain version on the CPU) on the sharded batch
    kmodel = matern_model(ls=0.3, ls_bounds=(0.01, 1.0), noise=1e-3,
                          noise_bounds=(1e-5, 1e-1))
    kc, kp, kt, kn = train_tensors(kmodel, p)
    ks = shard_batch((kc, kp, kt, kn), mesh)
    for loss in ("lool", "mse", "looph"):
        fused, names = make_fused_train_objective(
            kmodel, ks[2], ks[3], ks[0], ks[1], loss=loss, device="cpu"
        )
        v, g = fused({"length_scale": 0.07, "noise": 2e-3})
        out[f"k2_{loss}"] = [float(v)] + [float(g[n]) for n in names]
    kopt = Fused_L_BFGS_B_optimize(kmodel, ks[2], ks[3], ks[0], ks[1],
                                   device="cpu")
    out["k2_opt"] = [float(kopt.kernel.deformation.length_scale()),
                     float(kopt.noise())]

    # a sub-mesh of the first two ranks: its row arithmetic and a ragged
    # weighted objective over it
    sub = make_mesh(devices=[0, 1])
    sl = local_chunk_slice(12, sub)
    out["sub_slice"] = (sl.start, sl.stop)
    try:
        local_chunk_slice(13, sub)
        out["sub_ragged"] = ""
    except ValueError as err:
        out["sub_ragged"] = str(err)
    rag = tuple(t[:77] for t in (cw, pw, bt, bnt))
    (scw_, spw_, sbt_, sbnt_), sw = shard_ragged_global(rag, sub)
    out["sub_rows"] = int(scw_.shape[0])
    if rank < 2:
        sub_obj = L_BFGS_B_optimize.make_obj_fn(
            model, sbt_, sbnt_, scw_, spw_, loss_fn=lool_fn,
            loss_kwargs={"row_weights": sw},
        )
        out["sub_obj"] = float(sub_obj(length_scale=0.07))
    return out


# -- the mesh cases of tests/test_serve.py ----------------------------------


def _raises(fn, match):
    """The message of the ValueError ``fn`` raises ("" when it does not),
    checked against ``match``."""
    try:
        fn()
    except ValueError as err:
        assert match in str(err), str(err)
        return str(err)
    return ""


def serve_mesh_cases(rank, world, p):
    """FastServer under a mesh: queries sharded (lanes, kernel, fused; the
    shear lanes and kernel engines), the training rows sharded (fused), the
    refusals; each server's mode."""
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.parallel import make_mesh
    from muygpys_torch.serve import FastServer

    xtr, ytr, xte = p["xtr"], p["ytr"], p["xte"]
    mesh = make_mesh()
    model = matern_model(ls=0.5, ls_bounds="fixed", scale=2.0)
    nbrs = NN_Wrapper(xtr, 12, device="cpu")
    out = {"modes": []}
    for engine in ("lanes", "kernel", "fused"):
        server = FastServer(model, nbrs, xtr, ytr, bucket=64, engine=engine,
                            mesh=mesh)
        out["modes"].append(server.mode)
        out[engine] = server.predict(xte[:100])
    out["divide"] = _raises(lambda: FastServer(
        model, nbrs, xtr, ytr, bucket=60, engine="lanes", mesh=mesh),
        "divide")
    out["reference"] = _raises(lambda: FastServer(
        model, nbrs, xtr, ytr, bucket=64, engine="reference", mesh=mesh),
        "reference")

    n = (xtr.shape[0] // world) * world
    xt, yt = xtr[:n], ytr[:n]
    nt = NN_Wrapper(xt, 12, device="cpu")
    server = FastServer(model, nt, xt, yt, bucket=64, engine="fused",
                        mesh=mesh, shard="train")
    out["modes"].append(server.mode)
    out["train"] = server.predict(xte[:50])
    out["train_fused"] = _raises(lambda: FastServer(
        model, nt, xt, yt, bucket=64, engine="lanes", mesh=mesh,
        shard="train"), "fused")
    out["train_divide"] = _raises(lambda: FastServer(
        model, nt, xt[:-4], yt[:-4], bucket=64, engine="fused", mesh=mesh,
        shard="train"), "divide")
    out["train_shard"] = _raises(lambda: FastServer(
        model, nt, xt, yt, bucket=64, engine="fused", mesh=mesh,
        shard="nope"), "shard")

    smodel = shear_model(0.08, noise=1e-3 * 2.0 / 0.08**4)
    pts, targets, sq = p["shear_pts"], p["shear_targets3"], p["shear_xte"]
    snbrs = NN_Wrapper(pts, 8, device="cpu")
    for engine in ("lanes", "kernel"):
        server = FastServer(smodel, snbrs, pts, targets, bucket=40,
                            engine=engine, mesh=mesh)
        out["modes"].append(server.mode)
        out[f"shear_{engine}"] = server.predict(sq)
    return out
