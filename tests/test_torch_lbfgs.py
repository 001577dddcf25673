"""The port's L-BFGS state machine (muygpys_torch.optimize.lbfgs) against
the JAX package's ``lbfgs_while_loop`` (optax's L-BFGS and zoom line
search under one ``while_loop``), in f64 on the CPU, on objectives written
once for both array modules: a 2-D Rosenbrock, an ill-conditioned 3-D
quadratic and a log barrier whose line searches probe outside its domain
(NaN, scored as the large penalty).

Each trajectory is compared iterate by iterate: the JAX loop is compiled
once per objective with ``maxiter`` a traced argument and stopped after k
iterations, for k = 1..10 and uncapped.  The step is also run on the
``meta`` device, where any read of a value back to the host fails: it
holds no host sync, as a CUDA graph capture requires."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muygpys_tpu.optimize import device_chassis as jdc
from muygpys_torch.optimize import device_chassis as tdc
from muygpys_torch.optimize import lbfgs


def rosenbrock(xp, z):
    return (1.0 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2


def quadratic(xp, z):
    # eigenvalues ~1 to 1000, one coupling term, minimum off the origin
    return (0.5 * (z[0] ** 2 + 30.0 * z[1] ** 2 + 1000.0 * z[2] ** 2)
            + 0.5 * z[0] * z[1] - z[2])


def barrier(xp, z):
    # NaN outside the unit disc; the linear pull drives the interval search
    # across the boundary
    return (-0.01 * xp.log(1.0 - z[0] ** 2 - z[1] ** 2) - 2.0 * z[0]
            + (z[1] - 0.1) ** 2)


CASES = {
    "rosenbrock": (rosenbrock, [-1.2, 1.0]),
    "quadratic": (quadratic, [1.0, 1.0, 1.0]),
    "nan_region": (barrier, [-0.5, 0.1]),
}
CAPS = list(range(1, 11)) + [200]


def jax_fun(f):
    return lambda z: jdc._finite_or_big(f(jnp, z))


@pytest.fixture(scope="module")
def jax_runs():
    """{case: {maxiter: (z, iterations, value, gmax)}} from the JAX loop."""
    out = {}
    for name, (f, z0) in CASES.items():
        run = jax.jit(
            lambda z, m, f=f: jdc.lbfgs_while_loop(jax_fun(f), z, maxiter=m)
        )
        out[name] = {
            cap: tuple(np.asarray(a) for a in run(jnp.asarray(z0), cap))
            for cap in CAPS
        }
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_jax(name, jax_runs):
    f, z0 = CASES[name]
    for cap in CAPS:
        z, its, value, gmax = tdc.lbfgs_while_loop(
            lambda x: f(torch, x), torch.tensor(z0, dtype=torch.float64),
            maxiter=cap,
        )
        jz, jits, jvalue, _ = jax_runs[name][cap]
        # equal iteration counts on these three (no line-search test is
        # tipped by rounding)
        assert int(its) == int(jits), (cap, int(its), int(jits))
        rtol = 1e-10 if cap <= 10 else 1e-8
        np.testing.assert_allclose(z.numpy(), jz, rtol=rtol, atol=1e-14,
                                   err_msg=f"{name} after {cap}")
        assert abs(float(value) - float(jvalue)) <= 1e-10, (cap, value)
    # the uncapped run converged
    assert float(gmax) < 1e-3 or int(its) < 200


def test_nan_region_is_probed():
    """The barrier's line searches do leave its domain: those probes score
    the penalty, and the trajectory still ends inside."""
    values = []

    def fun(z):
        v = barrier(torch, z)
        values.append(float(v.detach()))
        return v

    z, its, value, _ = tdc.lbfgs_while_loop(
        fun, torch.tensor([-0.5, 0.1], dtype=torch.float64)
    )
    assert sum(np.isnan(values)) >= 1
    assert float(torch.sum(z * z)) < 1.0 and np.isfinite(float(value))


def test_steps_hold_no_host_sync():
    """Every step of a run on the meta device (no data: a host read raises)
    with a pure-torch objective; on the CPU the same objective converges."""
    def fun(z):
        weights = torch.arange(1.0, 4.0, device=z.device, dtype=z.dtype)
        return torch.sum((z - 1.0) ** 2 * weights)

    vag = lbfgs.autograd_value_and_grad(fun)
    state = lbfgs.init_state(torch.zeros(3, dtype=torch.float64,
                                         device="meta"))
    for _ in range(5):
        state = lbfgs.step(state, vag)
    assert all(t.device.type == "meta" for t in state.values())
    with pytest.raises(Exception):
        bool(state["done"])  # the meta device has no values to read
    z, its, _, gmax = tdc.lbfgs_while_loop(
        fun, torch.zeros(3, dtype=torch.float64)
    )
    # scipy's ftol stops it once the relative decrease falls below 2.2e-9
    np.testing.assert_allclose(z.numpy(), 1.0, rtol=1e-6)
    assert int(its) >= 1


def test_done_freezes_the_state():
    """A step after convergence changes nothing."""
    vag = lbfgs.autograd_value_and_grad(lambda z: rosenbrock(torch, z))
    run = tdc.Trajectory(vag, 2, "cpu")
    run.run(torch.tensor([-1.2, 1.0], dtype=torch.float64))
    state = run.state
    assert bool(state["done"])
    again = lbfgs.step(state, vag)
    for key in state:
        assert torch.equal(again[key], state[key]), key


def test_device_lbfgs_matches_jax(jax_runs):
    """device_lbfgs (the device chassis' general entry point, eager on the
    CPU) against JAX's on the quadratic."""
    z, info = tdc.device_lbfgs(
        lambda x: quadratic(torch, x),
        torch.tensor(CASES["quadratic"][1], dtype=torch.float64),
    )
    jz, jits, jvalue, jgmax = jax_runs["quadratic"][200]
    np.testing.assert_allclose(z.numpy(), jz, rtol=1e-8)
    assert info["iterations"] == int(jits)
    assert abs(info["value"] - float(jvalue)) <= 1e-10
    assert info["evaluations"] > info["iterations"]


def test_entry_points_default_to_cuda(monkeypatch):
    """A z0 that is not a tensor (a list, a numpy array, as JAX callers pass
    it) goes on the card: with none, the entry points raise instead of
    stepping on the CPU; ``device="cpu"`` asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fun = lambda x: quadratic(torch, x)  # noqa: E731
    z0 = np.asarray(CASES["quadratic"][1])
    for entry in (tdc.device_lbfgs, tdc.lbfgs_while_loop):
        for start in (z0, list(z0)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                entry(fun, start, maxiter=2)
    z, info = tdc.device_lbfgs(fun, z0, maxiter=2, device="cpu")
    assert z.device.type == "cpu" and info["iterations"] == 2
