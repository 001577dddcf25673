"""Worker process of the port's multi-process test.

Invoked as ``python _torch_mp_worker.py <process_id> <num_processes>
<port>``.  Each worker brings the world up through the production entry
point, ``initialize_distributed(coordinator_address=, num_processes=,
process_id=, device="cpu")`` (gloo), builds the hybrid ``(dcn, ici)`` mesh
(``LOCAL_WORLD_SIZE=1``: each process is a node), shards the batch from the
full host arrays (each process keeps its own rows), evaluates the lool
objective and its gradient, a posterior and the analytic scale over the
sharded batch, and a ragged 61-row batch through ``shard_ragged_global``;
it prints one ``MPRESULT`` JSON line.  It imports torch, numpy and the
port only.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_problem(batch=64):
    """The port's model and training tensors of ``_mp_problem.build_problem``
    (the same seed and draws)."""
    import numpy as np
    import torch

    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise

    rng = np.random.default_rng(1234)
    train_count, nn = 256, 10
    xtr = rng.uniform(size=(train_count, 2))
    ytr = rng.standard_normal((train_count, 1))
    bi = rng.choice(train_count, batch, replace=False)
    bni = np.stack(
        [rng.choice(train_count, nn, replace=False) for _ in range(batch)]
    )
    model = MuyGPS(
        kernel=Matern(
            smoothness=Parameter(1.5),
            deformation=Isotropy(l2, length_scale=Parameter(0.7, (0.05, 5.0))),
        ),
        noise=HomoscedasticNoise(2e-3, (1e-5, 1e-1)),
        scale=AnalyticScale(),
    )
    return model, model.make_train_tensors(
        bi, bni, torch.as_tensor(xtr), torch.as_tensor(ytr)
    )


def evaluate(model, tensors, row_weights=None):
    """lool value and gradient at (0.7, 2e-3), posterior sums and the
    analytic scale; serial on plain tensors, sharded on DTensors."""
    import torch

    from muygpys_torch.optimize import L_BFGS_B_optimize, lool_fn
    from muygpys_torch.parallel.sharding import shard_map

    cw, pw, bt, bnt = tensors
    obj = L_BFGS_B_optimize.make_obj_fn(
        model, bt, bnt, cw, pw, loss_fn=lool_fn,
        loss_kwargs=None if row_weights is None else {
            "row_weights": row_weights},
    )
    ls = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    noise = torch.tensor(2e-3, dtype=torch.float64, requires_grad=True)
    val = obj(length_scale=ls, noise=noise)
    g_ls, g_noise = torch.autograd.grad(val, (ls, noise))
    out = {"obj": float(val.detach()), "grad_length_scale": float(g_ls),
           "grad_noise": float(g_noise)}
    if row_weights is not None:
        return out

    def sums(cw_, pw_, bnt_):
        Kin, Kcross = model.kernel(pw_), model.kernel(cw_)
        mean, var = model.posterior_mean_and_variance(Kin, Kcross, bnt_)
        scale = model.scale.get_opt_fn(model)(Kin, bnt_)
        from muygpys_torch.parallel import comm

        return (comm.batch_sum(mean), comm.batch_sum(var),
                torch.as_tensor(scale).reshape(-1)[0])

    if isinstance(cw, torch.Tensor) and not hasattr(cw, "device_mesh"):
        m, v, s = sums(cw, pw, bnt)
    else:
        m, v, s = shard_map(sums, out_specs="replicate")(cw, pw, bnt)
    out.update(mean_sum=float(m), var_sum=float(v), scale=float(s))
    return out


def main() -> None:
    pid, nproc, port = (int(a) for a in sys.argv[1:4])
    import torch

    torch.set_num_threads(1)
    from muygpys_torch.parallel import (
        initialize_distributed,
        make_hybrid_mesh,
        shard_batch_global,
        shard_ragged_global,
    )

    ok = initialize_distributed(
        coordinator_address=f"localhost:{port}", num_processes=nproc,
        process_id=pid, device="cpu",
    )
    assert ok, "distributed init failed"
    import torch.distributed as dist

    assert dist.get_world_size() == nproc
    mesh = make_hybrid_mesh()
    assert tuple(mesh.shape) == (nproc, 1), mesh.shape
    model, tensors = build_problem()
    out = evaluate(model, shard_batch_global(tensors, mesh))
    _, rtensors = build_problem(batch=61)
    rsharded, rw = shard_ragged_global(rtensors, mesh)
    ragged = evaluate(model, rsharded, row_weights=rw)
    out.update(obj_ragged=ragged["obj"],
               grad_ls_ragged=ragged["grad_length_scale"], process=pid)
    print("MPRESULT " + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
