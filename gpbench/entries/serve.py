"""Serving entry: a trained model behind ``muygpys_torch.serve.FastServer``;
one call is one ``predict`` of a request's queries, host numpy in and out.

The configuration says the model (a Matérn kernel with homoscedastic
noise, or the shear kernel with the lensing nugget) and its neighbour
index; the workload file says the server's engine, bucket and re-rank.
Judged against the plain reference: each sampled query's neighbours found
again exactly, its posterior (mean and variance, or mean and 3 x 3
covariance) solved again in float64, and the widest gap taken; where the
cell's check names ``miss_over``, also the share of queries whose mean lies
further than that from the reference's (``mean_miss``), which a solve that
is wrong everywhere moves and one query with an approximate neighbour set
does not.
"""

from __future__ import annotations

import numpy as np

from gpbench.reference import knn as ref_knn
from gpbench.reference import matern as ref_matern
from gpbench.reference import shear as ref_shear
from gpbench.reference.precision import computing


class _Search:
    """The neighbour index as the server sees it, its searches inside the
    harness's ``search`` span."""

    def __init__(self, nbrs, tracer):
        self._nbrs, self._tracer = nbrs, tracer
        self.nn_count = nbrs.nn_count

    def get_nns(self, test):
        with self._tracer.span("search"):
            return self._nbrs.get_nns(test)


class _Count:
    """What the fused engine reads of a neighbour index: its ``nn_count``
    (it searches with its own)."""

    def __init__(self, nn_count):
        self.nn_count = nn_count


class Entry:
    def __init__(self, cfg, cell, x, y, device, tracer):
        from muygpys_torch.convert import muygps_from_arrays
        from muygpys_torch.neighbors import NN_Wrapper
        from muygpys_torch.serve import FastServer

        m = cfg["served"]
        if cfg["kernel"] == "shear":
            model = muygps_from_arrays(m["length_scale"], noise=m["noise"],
                                       scale=m["scale"], kernel="shear",
                                       noise_model="shear33")
        else:
            model = muygps_from_arrays(m["length_scale"], noise=m["noise"],
                                       scale=m["scale"],
                                       smoothness=cfg["smoothness"])
        self.cfg, self.device = cfg, device
        x_np, y_np = x.cpu().numpy(), y.cpu().numpy()
        server = cell["server"]
        if server["engine"] == "fused":
            index = _Count(cfg["nn_count"])
        else:
            index = _Search(NN_Wrapper(x_np, cfg["nn_count"],
                                       nn_method=cfg["nn_method"],
                                       device=device), tracer)
        self.server = FastServer(
            model, index, x_np, y_np,
            bucket=server["bucket"], engine=server["engine"],
            rerank=server.get("rerank", True), device=device,
        )

    def call(self, queries):
        """One request: ``(mean, variance)`` or ``(mean, covariance)``."""
        return self.server.predict(queries)

    def path(self) -> dict:
        """What the timed path must have been: captured on a card."""
        return {"captured": self.server.mode == "captured"}

    def close(self):
        del self.server


def answers(cfg, x, y, requests, precision, search=None):
    """The reference's own answers to ``requests`` (numpy queries): its
    exact neighbours, found in ``search`` (``precision`` where None), and
    its posterior, computed in ``precision``."""
    import torch

    q = torch.as_tensor(np.concatenate(requests), device=x.device)
    with computing(search or precision) as dt:
        idx = ref_knn.knn(x.to(dt), q.to(dt), cfg["nn_count"])
    with computing(precision) as dt:
        xr, yr, qr = x.to(dt), y.to(dt), q.to(dt)
        m = cfg["served"]
        if cfg["kernel"] == "shear":
            mean, second = ref_shear.posterior(
                xr, yr, idx, qr, m["length_scale"], m["noise"], m["scale"])
        else:
            mean, second = ref_matern.posterior(
                xr, yr, idx, qr, m["length_scale"], m["noise"],
                cfg["smoothness"], m["scale"])
    return mean.cpu().numpy(), second.cpu().numpy()


def _gaps(got, want):
    """``|got - want|`` per query (the widest over its outputs), infinite
    where either side is not a number."""
    gap = np.abs(got - want).reshape(len(got), -1).max(axis=1)
    return np.where(np.isfinite(gap), gap, np.inf)


def compare(cfg, check, x, y, requests, outputs) -> dict:
    """The widest gaps between the served answers and the float64
    reference's, over every query of the sampled requests, and, where the
    check names ``miss_over``, the share of queries whose mean gap exceeds
    it."""
    mean_ref, second_ref = answers(cfg, x, y, requests, "float64")
    mean = np.concatenate([np.asarray(o[0], np.float64).reshape(
        mean_ref[:len(r)].shape) for r, o in zip(requests, outputs)])
    second = np.concatenate([np.asarray(o[1], np.float64).reshape(
        second_ref[:len(r)].shape) for r, o in zip(requests, outputs)])
    mean_gaps = _gaps(mean, mean_ref)
    key = "cov_gap" if cfg["kernel"] == "shear" else "var_gap"
    out = {"mean_gap": float(mean_gaps.max()),
           key: float(_gaps(second, second_ref).max())}
    if "miss_over" in check:
        out["mean_miss"] = float(np.mean(mean_gaps > check["miss_over"]))
    return out


def control(cfg, x, y, requests, solve_only=False) -> list:
    """The control: the reference in the program's place, computed in the
    precision below the configuration's (TF32), one answer per request;
    with ``solve_only`` its neighbours found in float64 and only the
    solve in TF32."""
    mean, second = answers(cfg, x, y, requests, "tf32",
                           "float64" if solve_only else None)
    out, at = [], 0
    for r in requests:
        out.append((mean[at:at + len(r)], second[at:at + len(r)]))
        at += len(r)
    return out
