"""A general Matérn order served by ``FastServer(engine="fused")`` (on the
CPU: K1's plain version under ``"gen"``, f64), held to the benchmark's
independent Bessel reference (``gpbench/reference/matern_nu.py``: φ_ν
from a trapezoid rule on K_ν's integral, a dense Cholesky solve per
neighbourhood), which shares none of the program's mathematics.

The length scale puts the neighbourhoods across K4's split T0 = 2: at
ℓ = 0.03 over 4,096 uniform points, 38% of the crosswise entries and 58%
of the pairs lie past it, so both of K4's branches are judged.

Tolerances:

- the reference's φ against scipy's ``kv`` and the closed forms, rtol
  1e-12: the rule's error is below 1e-19 (the module's docstring), so
  what is left is the two sides' float64 rounding of t^ν K_ν(t) (≤ 3e-14
  measured over the grid);
- the server against the reference, atol 1e-7 on the mean and the
  variance: K4's surrogate is exact to ~1e-12 on φ in f64 (14 series
  terms, 40 Chebyshev terms), and the solve at noise 1e-3 lifts an error
  in K by up to its condition number, ~1e3–1e4 here (3.5e-9 measured);
- the server at ν = 3/2 misses the ν = 1.2 reference by more than 100x
  that tolerance (6.4e-2 measured): the comparison can tell the trained
  order from the nearest closed form.
"""

import ast
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import gamma, kv

from muygpys_torch.convert import muygps_from_arrays
from muygpys_torch.serve import FastServer

ROOT = Path(__file__).resolve().parents[1]
TRAIN, QUERIES, NN, LS, NOISE = 4096, 256, 30, 0.03, 1e-3
T0 = 2.0
TOL = 1e-7
T_GRID = [0.0, 1e-6, 1e-3, 0.1, 0.5, 1.0, T0 - 1e-9, T0, T0 + 1e-9, 3.0,
          7.5, 15.0, 25.0, 40.0]


def _ref():
    from gpbench.reference import matern_nu

    return matern_nu


def bessel_phi(t, nu):
    t = np.asarray(t, np.float64)
    out = np.ones_like(t)
    pos = t > 0
    out[pos] = 2 ** (1 - nu) / gamma(nu) * t[pos] ** nu * kv(nu, t[pos])
    return out


CLOSED = {
    0.5: lambda t: np.exp(-t),
    1.5: lambda t: (1 + t) * np.exp(-t),
    2.5: lambda t: (1 + t + t * t / 3) * np.exp(-t),
}


@pytest.mark.parametrize("nu", [0.31, 1.2, 3.7])
def test_reference_phi_against_scipy_kv(nu):
    t = torch.tensor(T_GRID, dtype=torch.float64)
    got = _ref().phi(t, nu).numpy()
    np.testing.assert_allclose(got, bessel_phi(T_GRID, nu), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("nu", sorted(CLOSED))
def test_reference_phi_against_the_closed_forms(nu):
    t = torch.tensor(T_GRID, dtype=torch.float64)
    got = _ref().phi(t, nu).numpy()
    np.testing.assert_allclose(got, CLOSED[nu](np.array(T_GRID)),
                               rtol=1e-12, atol=0)


class _Count:
    """The fused engine reads only ``nn_count`` of a neighbour index."""

    nn_count = NN


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(1200)
    x = rng.uniform(size=(TRAIN, 2))
    y = (np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         + 0.1 * rng.standard_normal(TRAIN))
    q = rng.uniform(size=(QUERIES, 2))
    return x, y, q


@pytest.fixture(scope="module")
def reference(field):
    from gpbench.reference import knn

    x, y, q = (torch.as_tensor(a) for a in field)
    idx = knn.knn(x, q, NN)
    mean, var = _ref().posterior(x, y, idx, q, LS, NOISE, 1.2)
    return idx, mean.numpy(), var.numpy()


def serve(field, nu):
    x, y, q = field
    model = muygps_from_arrays(LS, noise=NOISE, scale=1.0, smoothness=nu)
    server = FastServer(model, _Count(), x, y[:, None], bucket=QUERIES,
                        engine="fused", rerank=True, device="cpu")
    mean, var = server.predict(q)
    return server, mean[:, 0], var


def test_neighbourhoods_straddle_the_split(field, reference):
    """Between a quarter and three quarters of K1's entries (the
    neighbourhood's pairs and the crosswise ones) lie past T0."""
    from gpbench.reference.matern import _dist

    x, _, q = (torch.as_tensor(a) for a in field)
    nx = x[reference[0]]
    scale = math.sqrt(2 * 1.2) / LS
    rows, cols = torch.triu_indices(NN, NN, 1)
    t = torch.cat([(scale * _dist(q[:, None], nx)).reshape(-1),
                   (scale * _dist(nx, nx))[:, rows, cols].reshape(-1)])
    assert 0.25 < float(torch.mean((t > T0).double())) < 0.75


def test_fused_server_at_nu_1_2_matches_the_reference(field, reference):
    _, mean, var = serve(field, 1.2)
    np.testing.assert_allclose(mean, reference[1], rtol=0, atol=TOL)
    np.testing.assert_allclose(var, reference[2], rtol=0, atol=TOL)


def test_the_nearest_closed_form_misses_the_reference(field, reference):
    _, mean, _ = serve(field, 1.5)
    assert np.abs(mean - reference[1]).max() > 100 * TOL


@pytest.mark.parametrize("nu,form", [(1.2, "gen"), (1.5, 1.5)])
def test_kernel_form(field, nu, form):
    """K1's form: the general order through K4's coefficient vector at
    1.2, the closed form's formula (no vector) at 3/2."""
    server, _, _ = serve(field, nu)
    smoothness, coeffs = server._smoothness, server._gen_coeffs
    assert smoothness == form
    assert (coeffs is not None and coeffs.numel() > 0) == (form == "gen")


def test_reference_imports_nothing_of_the_program():
    path = ROOT / "gpbench" / "reference" / "matern_nu.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "math", "torch", "gpbench"}, roots
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpbench.reference.matern_nu; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"muygpys_torch", "muygpys_tpu", "jax", "jaxlib"}
