"""Serving entry for a Matérn model of a general smoothness ν: the serving
entry's server (``entries/serve.py``), judged against the Bessel reference
(``reference/matern_nu.py``) in place of the closed forms'.
The cell's path check reads the launches of K1 under ``"gen"`` (K4's
coefficients), ``_build.launches["fused_predict_coords/gen"]``; a program
that does not count them cannot show which form of the kernel it served,
and the entry refuses to run on it.
"""

from __future__ import annotations

import numpy as np

from gpbench.entries import serve
from gpbench.reference import knn as ref_knn
from gpbench.reference import matern_nu as ref_nu
from gpbench.reference.precision import computing


class Entry(serve.Entry):
    def __init__(self, cfg, cell, x, y, device, tracer):
        from muygpys_torch.gpu import _build

        if "fused_predict_coords/gen" not in _build.launches:
            raise RuntimeError(
                "the program does not count K1's general-order launches: "
                "it cannot show which form of the kernel it served")
        super().__init__(cfg, cell, x, y, device, tracer)


def answers(cfg, x, y, requests, precision, search=None):
    """The reference's own answers to ``requests`` (numpy queries): its
    exact neighbours, found in ``search`` (``precision`` where None), and
    its posterior at the configuration's smoothness, computed in
    ``precision``."""
    import torch

    q = torch.as_tensor(np.concatenate(requests), device=x.device)
    with computing(search or precision) as dt:
        idx = ref_knn.knn(x.to(dt), q.to(dt), cfg["nn_count"])
    with computing(precision) as dt:
        m = cfg["served"]
        mean, var = ref_nu.posterior(
            x.to(dt), y.to(dt), idx, q.to(dt), m["length_scale"],
            m["noise"], cfg["smoothness"], m["scale"])
    return mean.cpu().numpy(), var.cpu().numpy()


def compare(cfg, check, x, y, requests, outputs) -> dict:
    """The widest gaps of the mean and the variance from the float64
    reference's, over every query of the sampled requests, and the share
    of queries whose mean gap exceeds the check's ``miss_over``."""
    mean_ref, var_ref = answers(cfg, x, y, requests, "float64")
    mean = np.concatenate([np.asarray(o[0], np.float64).reshape(len(r))
                           for r, o in zip(requests, outputs)])
    var = np.concatenate([np.asarray(o[1], np.float64).reshape(len(r))
                          for r, o in zip(requests, outputs)])
    mean_gaps = serve._gaps(mean, mean_ref)
    return {"mean_gap": float(mean_gaps.max()),
            "var_gap": float(serve._gaps(var, var_ref).max()),
            "mean_miss": float(np.mean(mean_gaps > check["miss_over"]))}


def control(cfg, x, y, requests, solve_only=False) -> list:
    """The control: the reference in the program's place, computed in the
    precision below the configuration's (TF32), one answer per request;
    with ``solve_only`` its neighbours found in float64 and only the
    correlation and solve in TF32's precision."""
    mean, var = answers(cfg, x, y, requests, "tf32",
                        "float64" if solve_only else None)
    out, at = [], 0
    for r in requests:
        out.append((mean[at:at + len(r)], var[at:at + len(r)]))
        at += len(r)
    return out
