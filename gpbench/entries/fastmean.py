"""Fast-mean serving entry: Fast MuyGPs behind
``muygpys_torch.serve.FastServer(engine="fast_mean")``; one call is one
``predict`` of a request's queries, host numpy in, the mean out as a
one-tuple ``(mean,)``.

The configuration says the model (a Matérn kernel with homoscedastic
noise) and the index the precompute searches with; the workload file says
the server's engine, bucket and re-rank.  The server's construction runs
the precompute, so it is part of the set-up.  Judged against the plain
reference (``reference/fastmean.py``): each sampled query's nearest
training point and that point's neighbourhood found again exactly, the
neighbourhood's coefficients solved again in float64, and the widest gap
taken (``mean_gap``); where the cell's check names ``miss_over``, also the
share of queries whose mean lies further than that from the reference's
(``mean_miss``), which a solve that is wrong everywhere moves and one
query served from another nearest point does not.
"""

from __future__ import annotations

import numpy as np

from gpbench.reference import fastmean as ref_fast
from gpbench.reference.precision import computing


class Entry:
    def __init__(self, cfg, cell, x, y, device, tracer):
        from muygpys_torch.convert import muygps_from_arrays
        from muygpys_torch.neighbors import NN_Wrapper
        from muygpys_torch.serve import FastServer

        m = cfg["served"]
        model = muygps_from_arrays(m["length_scale"], noise=m["noise"],
                                   scale=m["scale"],
                                   smoothness=cfg["smoothness"])
        x_np, y_np = x.cpu().numpy(), y.cpu().numpy()
        nbrs = NN_Wrapper(x_np, cfg["nn_count"], nn_method=cfg["nn_method"],
                          device=device)
        server = cell["server"]
        self.server = FastServer(
            model, nbrs, x_np, y_np,
            bucket=server["bucket"], engine=server["engine"], device=device,
        )

    def call(self, queries):
        """One request: ``(mean,)``."""
        mean, _ = self.server.predict(queries)
        return (mean,)

    def path(self) -> dict:
        """What the timed path must have been: captured on a card."""
        return {"captured": self.server.mode == "captured"}

    def close(self):
        del self.server


def answers(cfg, x, y, requests, precision, search=None):
    """The reference's fast means of ``requests`` (numpy queries): its
    exact nearest points and neighbourhoods, found in ``search``
    (``precision`` where None), and their coefficients and the means,
    computed in ``precision``."""
    import torch

    q = torch.as_tensor(np.concatenate(requests), device=x.device)
    with computing(search or precision) as dt:
        sets, row = ref_fast.neighbourhoods(x.to(dt), q.to(dt),
                                            cfg["nn_count"])
    with computing(precision) as dt:
        m = cfg["served"]
        mean = ref_fast.posterior_mean(
            x.to(dt), y.to(dt), q.to(dt), sets, row, m["length_scale"],
            m["noise"], cfg["smoothness"])
    return mean.cpu().numpy()


def compare(cfg, check, x, y, requests, outputs) -> dict:
    """The widest gap between the served means and the float64
    reference's, over every query of the sampled requests, and, where the
    check names ``miss_over``, the share of queries whose gap exceeds
    it."""
    want = answers(cfg, x, y, requests, "float64")
    got = np.concatenate([np.asarray(o[0], np.float64).reshape(len(r))
                          for r, o in zip(requests, outputs)])
    gaps = np.abs(got - want)
    gaps = np.where(np.isfinite(gaps), gaps, np.inf)
    out = {"mean_gap": float(gaps.max())}
    if "miss_over" in check:
        out["mean_miss"] = float(np.mean(gaps > check["miss_over"]))
    return out


def control(cfg, x, y, requests, solve_only=False) -> list:
    """The control: the reference in the program's place, computed in the
    precision below the configuration's (TF32), one answer per request;
    with ``solve_only`` its neighbourhoods found in float64 and only the
    solve in TF32."""
    mean = answers(cfg, x, y, requests, "tf32",
                   "float64" if solve_only else None)
    out, at = [], 0
    for r in requests:
        out.append((mean[at:at + len(r), None],))
        at += len(r)
    return out
