"""muygpys_torch.performance (the headline programs and the pipeline
harness) against muygpys_tpu.performance, on the CPU.

Every input maker gives JAX's arrays bit for bit, at full size.  One
iteration of each loop runs against the JAX package's lanes (``xla_*``)
counterpart in f64 (JAX's loops run eagerly under ``jax.disable_jit`` so
their carries take f64; the port's constants that JAX makes in f32, the
noise and the free smoothness's start, are set to their f32 values), at a
reduced size in both modules (batch 256, nn 8; shear batch 128, nn 4).  Tolerances: 1e-10
relative where both sides compute the same algebra; 1e-5 where K4's
surrogate stands for the exact Bessel function (the free-smoothness
training gate of the port's K2 against the exact lanes objective).
The card-only timing (``measure``) is checked for its median and its
refusal of CPU inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import muygpys_tpu.performance.headline as jh
import muygpys_torch.performance.headline as th

SAME = 1e-10
SURROGATE = 1e-5


@pytest.mark.parametrize("maker", [
    "make_inputs", "make_coords_inputs", "make_serve_inputs",
    "make_train_inputs", "make_shear_inputs", "make_serve_1m_inputs",
])
def test_input_makers_are_bit_equal(maker):
    port = getattr(th, maker)(device="cpu")
    ref = getattr(jh, maker)()
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def small():
    """Both modules at batch 256 (shear 128), nn 8 (shear 4), 5,000
    training rows; the port's f32-made JAX constants at their f32 values.

    The port's side runs on one CPU thread: right after JAX's million-row
    builders, while JAX's runtime threads are still busy, multithreaded
    CPU kernels of torch were seen to return a Matern matrix off by 3e-9
    on the first call (the same call on one thread, or a few seconds
    later, is exact), which these 1e-10 comparisons would catch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for m in (jh, th):
            for name, value in (("BATCH", 256), ("TRAIN_BATCH", 256),
                                ("SHEAR_BATCH", 128), ("TRAIN_COUNT", 5000),
                                ("NN", 8), ("SHEAR_NN", 4)):
                mp.setattr(m, name, value)
        mp.setattr(th, "NOISE", float(np.float32(th.NOISE)))
        mp.setattr(th, "NU0_GEN", float(np.float32(th.NU0_GEN)))
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def _coords_as_dists(nf, q, y):
    pw = jnp.sqrt(jnp.sum((nf[:, None] - nf[None]) ** 2, axis=2))
    cw = jnp.sqrt(jnp.sum((nf - q[None]) ** 2, axis=1))
    return cw, pw, y


def _jax_f64(maker, loop, kw, convert=None):
    args = tuple(jnp.asarray(np.asarray(a), jnp.float64)
                 for a in getattr(jh, maker)())
    if convert is not None:
        args = convert(*args)
    with jax.disable_jit():
        return float(getattr(jh, loop)(1, **kw)(*args))


def _port_f64(maker, loop, kw):
    args = [t.double() for t in getattr(th, maker)(device="cpu")]
    return float(getattr(th, loop)(1, **kw)(*args))


# (maker, port loop, its kwargs, JAX lanes loop, its kwargs, tolerance)
CASES = [
    ("make_inputs", "xla_loop", {}, "xla_loop", {}, SAME),
    ("make_inputs", "pallas_loop", {}, "xla_loop", {}, SAME),
    ("make_coords_inputs", "pallas_coords_loop", {}, "xla_loop", {}, SAME),
    ("make_train_inputs", "xla_train_loop", {}, "xla_train_loop", {}, SAME),
    ("make_train_inputs", "fused_train_loop", {}, "xla_train_loop", {},
     SAME),
    ("make_shear_inputs", "shear_serve_loop", {"engine": "lanes"},
     "shear_serve_loop", {"engine": "lanes"}, SAME),
    ("make_shear_inputs", "shear_serve_loop", {"engine": "pallas"},
     "shear_serve_loop", {"engine": "lanes"}, SAME),
    ("make_serve_inputs", "knn_loop", {}, "knn_loop", {}, SAME),
    ("make_serve_inputs", "knn_loop", {"engine": "pallas"}, "knn_loop", {},
     SAME),
    ("make_serve_inputs", "end_to_end_loop", {"use_pallas": False},
     "end_to_end_loop", {"use_pallas": False}, SAME),
    ("make_serve_inputs", "end_to_end_loop", {}, "end_to_end_loop",
     {"use_pallas": False}, SAME),
    ("make_serve_inputs", "end_to_end_loop", {"rerank": False},
     "end_to_end_loop", {"use_pallas": False}, SAME),
]


@pytest.mark.parametrize(
    "maker,loop,kw,jloop,jkw,tol", CASES,
    ids=[f"{c[1]}-{c[2]}" for c in CASES],
)
def test_one_iteration_matches_jax(small, maker, loop, kw, jloop, jkw,
                                   tol):
    convert = _coords_as_dists if maker == "make_coords_inputs" else None
    ref = _jax_f64(maker, jloop, jkw, convert)
    got = _port_f64(maker, loop, kw)
    np.testing.assert_allclose(got, ref, rtol=tol)


def test_free_smoothness_loops(small):
    """The exact-Bessel lanes step against JAX's (JAX's f32 program, its
    loop carries being f32 under ``jit``: held at f32's accuracy of the
    objective, 1e-5), and K2 under K4 against the exact step in f64."""
    exact = _port_f64("make_train_inputs", "xla_train_loop_gen", {})
    fused = _port_f64("make_train_inputs", "fused_train_loop_gen", {})
    jax32 = float(jh.xla_train_loop_gen(1)(*jh.make_train_inputs()))
    np.testing.assert_allclose(jax32, exact, rtol=SURROGATE)
    np.testing.assert_allclose(fused, exact, rtol=SURROGATE)


def test_coords_gen_loop_against_exact_bessel(small):
    """K1 with K4 inlined (its plain version) against the exact Matern at
    nu = 1.2 (the port's Bessel function, held to JAX's in
    test_torch_bessel.py) through the lanes solve, on the same
    coordinates."""
    from muygpys_torch.ops.kernels import matern_gen_fn
    from muygpys_torch.ops.lanes_solver import serve_mean_and_variance_bl

    nf, q, y = (t.double() for t in th.make_coords_inputs(device="cpu"))
    pw = torch.sqrt(torch.sum((nf[:, None] - nf[None]) ** 2, dim=2))
    cw = torch.sqrt(torch.sum((nf - q[None]) ** 2, dim=1))
    nu = float(np.float32(1.2))
    Kin = (matern_gen_fn(pw / th.LENGTH_SCALE, nu)
           + th.NOISE * torch.eye(th.NN, dtype=torch.float64)[:, :, None])
    mean, var = serve_mean_and_variance_bl(
        Kin, matern_gen_fn(cw / th.LENGTH_SCALE, nu), 1.0, y
    )
    ref = float(torch.sum(mean) + torch.sum(var))
    got = _port_f64("make_coords_inputs", "pallas_coords_gen_loop", {})
    np.testing.assert_allclose(got, ref, rtol=SURROGATE)


def test_loops_run_iterations_with_the_jax_perturbation(small):
    """``iters`` iterations accumulate, each with its input scaled by
    ``1 + 1e-9 i``: three iterations equal JAX's three."""
    args = tuple(jnp.asarray(np.asarray(a), jnp.float64)
                 for a in jh.make_inputs())
    with jax.disable_jit():
        ref = float(jh.xla_loop(3)(*args))
    got = float(th.xla_loop(3)(*(t.double() for t in
                                 th.make_inputs(device="cpu"))))
    np.testing.assert_allclose(got, ref, rtol=SAME)


def test_measure_reports_the_true_median(monkeypatch):
    """An even count of repeats: the median is the middle pair's mean (the
    JAX harness takes the upper-middle element); ``best`` the least."""
    times = iter([4.0, 1.0, 3.0, 2.0])
    monkeypatch.setattr(th, "compile_loops", lambda f, i: (None, None))
    monkeypatch.setattr(th, "_replay_seconds",
                        lambda program, iters: next(times) * iters)
    best, spread = th.measure(th.xla_loop, (), repeats=4, stats=True)
    assert best == 1.0
    assert spread == {"repeats": 4, "median": 2.5, "min": 1.0, "max": 4.0}


def test_measure_refuses_cpu_inputs():
    """A device time comes from the device: CPU inputs raise."""
    with pytest.raises(ValueError, match="CUDA device"):
        th.measure(th.pallas_coords_loop,
                   th.make_coords_inputs(device="cpu"))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.make_inputs()


def test_benchmark_pipeline_runs_on_the_cpu(tmp_path):
    """Every stage of the JAX harness is timed, the stages compute what
    they name, and ``profile_dir`` writes a torch.profiler trace."""
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise
    from muygpys_torch.performance.benchmark import (
        BenchmarkPipeline,
        benchmark_fn,
    )

    model = MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=Parameter(0.5, (0.1, 2.0)))),
        noise=HomoscedasticNoise(1e-3),
        scale=AnalyticScale(),
    )
    bench = BenchmarkPipeline(model, batch_count=64, nn_count=10,
                              profile_dir=str(tmp_path / "trace"),
                              device="cpu")
    timings = bench.run(iters=2)
    assert set(timings) == {
        "pairwise_tensor", "crosswise_tensor", "kernel_Kin", "kernel_Kcross",
        "posterior_mean", "posterior_variance", "scale_optim",
        "lool_objective", "lool_objective_grad",
    }
    assert all(v > 0 and np.isfinite(v) for v in timings.values())
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    # the JAX harness's draws, in its order
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(bench.features.numpy(),
                                  rng.uniform(size=(128, 4)))
    rng.standard_normal((128, 1))
    np.testing.assert_array_equal(bench.nn_indices.numpy(),
                                  rng.integers(64, 128, size=(64, 10)))
    calls = []
    assert benchmark_fn(lambda: calls.append(1) or torch.zeros(1),
                        iters=3, warmup=2) >= 0
    assert len(calls) == 5
