"""The CUDA kernels against their plain versions on the card.

Needs an NVIDIA card and nvcc; skips elsewhere (the decision is made inside
each test).  On a machine with a card:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from muygpys_torch.gpu import _build
from muygpys_torch.gpu import knn as K
from muygpys_torch.gpu.fused_predict import (
    fused_predict_bl,
    fused_predict_bl_plain,
    fused_predict_coords_bl,
    fused_predict_coords_bl_plain,
)
from muygpys_torch.gpu.matern_nu import matern_nu_coeffs, matern_nu_coeffs_host

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# (mean, variance) absolute limits.  f64: both orders exact to ~1e-16 x
# the conditioning at noise 1e-3.  f32: on these inputs each order sits
# within 6e-4 (mean) and 3e-6 (variance) of f64, and the smallest variance
# is ~5e-4, so a zero or wrongly scaled variance fails
K1_TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (5e-3, 2e-5)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "smoothness,power,hetero",
    [(0.5, 1, False), (1.5, 1, False), (2.5, 1, True), (math.inf, 1, False),
     ("rbf", 2, False)],
)
def test_k1_kernel_matches_plain(smoothness, power, hetero, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    n, d, r, B = 12, 3, 2, 1000  # B not a multiple of the block's 8 queries
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    nf = torch.rand((n, d, B), **opts).to(dtype)
    q = torch.rand((d, B), **opts).to(dtype)
    y = torch.randn((n, r, B), **opts).to(dtype)
    params = torch.tensor([0.5, 0.7, 0.9, 1e-3], dtype=dtype, device="cuda")
    noise_nn = (torch.rand((n, B), **opts) * 1e-2).to(dtype) if hetero else None
    before = _build.launches["fused_predict_coords"]
    mk, vk = fused_predict_coords_bl(
        nf, q, y, params, noise_nn, smoothness=smoothness, metric_power=power
    )
    assert _build.launches["fused_predict_coords"] == before + 1
    mp, vp = fused_predict_coords_bl_plain(
        nf, q, y, params, noise_nn, smoothness=smoothness, metric_power=power
    )
    tol_m, tol_v = K1_TOL[dtype]
    rtol = 1e-9 if dtype == torch.float64 else 0.0
    assert tol_v <= 0.1 * float(vp.abs().min())
    torch.testing.assert_close(mk, mp, rtol=rtol, atol=tol_m)
    torch.testing.assert_close(vk, vp, rtol=rtol, atol=tol_v)


# general smoothness: a small and a large order, and the clamp zone
GEN_NUS = [0.31, 1.2, 2.0, 4.8]


def _gen_coeffs(nu, dtype, train=False, need_dnu=False):
    """Coefficients as the entry points build them: serving on the host in
    f64, then cast; training in the data's dtype (clamp 1e-2 in f32)."""
    if not train:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        return torch.as_tensor(matern_nu_coeffs_host(nu, np_dtype)).cuda()
    return matern_nu_coeffs(torch.tensor(nu, dtype=dtype), need_dnu).cuda()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nu", GEN_NUS)
def test_k1_gen_kernel_matches_plain(nu, dtype):
    """K4 inlined in K1: distances on both sides of the series/tail split
    (t = sqrt(2 nu) u / ls up to ~9) and a heteroscedastic nugget."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    n, d, r, B = 12, 3, 2, 1000
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    nf = torch.rand((n, d, B), **opts).to(dtype)
    q = torch.rand((d, B), **opts).to(dtype)
    y = torch.randn((n, r, B), **opts).to(dtype)
    params = torch.tensor([0.5, 0.7, 0.9, 1e-3], dtype=dtype, device="cuda")
    noise_nn = (torch.rand((n, B), **opts) * 1e-2).to(dtype)
    co = _gen_coeffs(nu, dtype)
    before = _build.launches["fused_predict_coords"]
    mk, vk = fused_predict_coords_bl(
        nf, q, y, params, noise_nn, gen_coeffs=co, smoothness="gen"
    )
    torch.cuda.synchronize()
    assert _build.launches["fused_predict_coords"] == before + 1
    mp, vp = fused_predict_coords_bl_plain(
        nf, q, y, params, noise_nn, gen_coeffs=co, smoothness="gen"
    )
    tol_m, tol_v = K1_TOL[dtype]
    # f64: the series/tail cancellation costs ~e^2 x 1e-16 per element
    rtol = 1e-8 if dtype == torch.float64 else 0.0
    assert tol_v <= 0.1 * float(vp.abs().min())
    torch.testing.assert_close(mk, mp, rtol=rtol, atol=tol_m * 10 if dtype == torch.float64 else tol_m)
    torch.testing.assert_close(vk, vp, rtol=rtol, atol=tol_v * 10 if dtype == torch.float64 else tol_v)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "smoothness,power", [(0.5, 1), (1.5, 1), (2.5, 1), (math.inf, 1),
                         ("rbf", 2), (0.31, 1), (1.2, 1), (2.0, 1), (4.8, 1)],
)
def test_k1b_kernel_matches_plain(smoothness, power, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    n, r, B = 30, 2, 1001
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    pts = torch.rand((n, 2, B), **opts)
    q = torch.rand((2, B), **opts)
    pw = ((pts[:, None] - pts[None, :]) ** 2).sum(2)
    cw = ((pts - q[None]) ** 2).sum(1)
    if power == 1:
        pw, cw = pw.sqrt(), cw.sqrt()
    y = torch.randn((n, r, B), **opts)
    params = torch.tensor([0.6, 1e-3], dtype=dtype, device="cuda")
    gen = smoothness in GEN_NUS
    co = _gen_coeffs(smoothness, dtype) if gen else None
    args = [t.to(dtype).contiguous() for t in (pw, cw, y)] + [params, co]
    kw = dict(smoothness="gen" if gen else smoothness, metric_power=power)
    before = _build.launches["fused_predict"]
    mk, vk = fused_predict_bl(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launches["fused_predict"] == before + 1
    mp, vp = fused_predict_bl_plain(*args, **kw)
    assert torch.isfinite(mk).all() and torch.isfinite(vk).all()
    # n = 30 at noise 1e-3: conditioning ~1e5, so f64 1e-9 and f32 as K1's
    tol_m, tol_v = ((1e-9, 1e-9) if dtype == torch.float64
                    else (2e-2, 2e-5))
    torch.testing.assert_close(mk, mp, rtol=0, atol=tol_m)
    torch.testing.assert_close(vk, vp, rtol=0, atol=tol_v)


@pytest.mark.parametrize("pruned", [False, True])
def test_k3_kernel_matches_plain_bitwise(pruned):
    _need_card()
    rng = np.random.default_rng(0)
    train = torch.as_tensor(rng.uniform(size=(9000, 2)), device="cuda")
    queries = torch.as_tensor(rng.uniform(size=(300, 2)), device="cuda")
    train = train[K.spatial_sort(train)]
    prep = (K.prepare_pruned if pruned else K.prepare)(train, queries, 38)
    s1, s2 = prep.candidates()
    p1, p2 = K.knn_candidates_plain(
        prep.q, prep.qsq, prep.tT, prep.tsq, prep.bins, prep.train_tile,
        prep.query_tile, prep.chunk_mask, prep.lb, prep.ub,
    )
    assert torch.equal(s1, p1) and torch.equal(s2, p2)


def test_kernel_wrappers_check_inputs():
    _need_card()
    prep = K.prepare(
        torch.rand((4096, 2), device="cuda"), torch.rand((128, 2), device="cuda"),
        30,
    )
    with pytest.raises(ValueError, match="float32"):
        prep._replace(qsq=prep.qsq.double()).candidates()
    with pytest.raises(ValueError, match="geometry"):
        prep._replace(query_tile=100).candidates()


# (smoothness, metric_power, noise_free, r, d_feat, heteroscedastic)
K2_CASES = [
    (0.5, 1, False, 1, 0, False),
    (1.5, 1, True, 1, 0, False),
    ("rbf", 2, True, 2, 0, False),
    (2.5, 1, False, 1, 2, False),
    (math.inf, 1, True, 2, 2, False),
    (1.5, 1, False, 1, 0, True),
]


def k2_row_errors(out, ref, r):
    """(max abs error, magnitude) per row: the magnitude is the smallest
    value for the positive rows (var, q), the largest |value| otherwise."""
    positive = {r, r + 1}
    res = []
    for i in range(ref.shape[0]):
        err = float((out[i] - ref[i]).abs().max())
        mag = (float(ref[i].abs().min()) if i in positive
               else float(ref[i].abs().max()))
        res.append((err, mag))
    return res


# the shapes K2 runs at: every case at n = 30 (the register design), and
# the headline and anisotropic r = 2 cases on both sides of the 32 <-> 33
# boundary between the register and the shared-memory design
K2_SHAPES = [(c, 30) for c in K2_CASES] + [
    (K2_CASES[1], n) for n in (8, 32, 33, 40)
] + [(K2_CASES[4], n) for n in (8, 32, 33, 40)]


def k2_expected_design(n, r):
    return "registers" if n <= 32 and r <= 4 else "shared"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "case,n", K2_SHAPES, ids=[f"{c}-n{n}" for c, n in K2_SHAPES],
)
def test_k2_kernel_matches_plain(case, n, dtype):
    """Each shape through the design the launcher takes for it (counted
    apart); n = 40 gives a warp more rows than lanes and, in f64, a block of
    fewer than 8 points."""
    _need_card()
    from muygpys_torch.gpu.fused_train import (
        fused_train_stats_bl,
        fused_train_stats_bl_plain,
    )

    smoothness, power, noise_free, r, d_feat, hetero = case
    g = torch.Generator(device="cuda").manual_seed(1)
    B = 1000  # not a multiple of the block's 8 points
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    pts = torch.rand((n, 2, B), **opts) * 0.05
    q = torch.rand((2, B), **opts) * 0.05
    diff_p = pts[:, None] - pts[None, :]  # (n, n, 2, B)
    diff_c = pts - q[None]  # (n, 2, B)
    if d_feat:
        pw, cw = diff_p, diff_c
        params = [0.3, 0.4]
    else:
        pw, cw = (diff_p**2).sum(2), (diff_c**2).sum(1)
        if power == 1:
            pw, cw = pw.sqrt(), cw.sqrt()
        params = [0.3]
    params = torch.tensor(params + [2e-2, 1e-2], device="cuda")
    y = torch.randn((n, r, B), **opts)
    noise_nn = torch.rand((n, B), **opts) * 1e-2 + 1e-2 if hetero else None
    args = [t.to(dtype).contiguous() if t is not None else None
            for t in (pw, cw, y, params, noise_nn)]
    kw = dict(smoothness=smoothness, metric_power=power,
              noise_free=noise_free, d_feat=d_feat)
    design = f"fused_train_stats/{k2_expected_design(n, r)}"
    before = dict(_build.launches)
    out = fused_train_stats_bl(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launches["fused_train_stats"] == before["fused_train_stats"] + 1
    assert _build.launches[design] == before[design] + 1
    ref = fused_train_stats_bl_plain(*args, **kw)
    assert torch.isfinite(out).all()
    # f64: both orders exact to ~1e-16 x the conditioning (<~1e4 here);
    # f32: a hundredth of each row's magnitude
    rel = 1e-9 if dtype == torch.float64 else 1e-2
    for i, (err, mag) in enumerate(k2_row_errors(out, ref, r)):
        assert err <= rel * mag, f"row {i}: error {err} against {mag}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k2_both_designs_agree_and_registers_refuse_n33(dtype):
    """At n = 30 the shared-memory design, forced, gives the register
    design's rows; the register kernel refuses n = 33 (past one lane per
    row) with a CUDA error, never a plain fall-back."""
    _need_card()
    from muygpys_torch.gpu import fused_train as K2

    g = torch.Generator(device="cuda").manual_seed(6)
    B = 300
    for n in (30, 33):
        pts = torch.rand((n, 2, B), dtype=torch.float64, device="cuda", generator=g)
        pw = ((pts[:, None] - pts[None]) ** 2).sum(2).sqrt().to(dtype)
        cw = ((pts - pts[:1]) ** 2).sum(1).sqrt().to(dtype) + 0.01
        y = torch.randn((n, 2, B), dtype=torch.float64, device="cuda",
                        generator=g).to(dtype)
        params = torch.tensor([0.4, 2e-2, 1e-2], dtype=dtype, device="cuda")
        launch = lambda design: K2._launch(  # noqa: E731
            pw, cw, y, params, None, None, 1, 1, True, False, 0, design
        )
        if n == 33:
            with pytest.raises(RuntimeError, match="CUDA error"):
                launch("registers")
            continue
        regs, shared = launch("registers"), launch("shared")
        torch.cuda.synchronize()
        rel = 1e-9 if dtype == torch.float64 else 1e-2
        for i, (err, mag) in enumerate(k2_row_errors(regs, shared, 2)):
            assert err <= rel * mag, f"row {i}: error {err} against {mag}"


# (nu, free nu, noise_free, r, d_feat, heteroscedastic)
K2_GEN_CASES = [
    (1.2, False, True, 1, 0, False),
    (1.2, True, True, 1, 0, False),
    (0.31, True, False, 2, 0, True),
    (4.8, True, True, 1, 2, False),
    (2.0, True, False, 2, 2, False),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "case,n",
    [(c, 30) for c in K2_GEN_CASES] + [(K2_GEN_CASES[1], 32),
                                       (K2_GEN_CASES[3], 40)],
    ids=[f"{c}-n{n}" for c, n in
         [(c, 30) for c in K2_GEN_CASES] + [(K2_GEN_CASES[1], 32),
                                            (K2_GEN_CASES[3], 40)]],
)
def test_k2_gen_kernel_matches_plain(case, n, dtype):
    """K2 under "gen", fixed and free nu: every row, the d/dnu group
    included, against the plain version.  n = 40 anisotropic with the S
    field makes an f64 block hold fewer than 8 points."""
    _need_card()
    from muygpys_torch.gpu.fused_train import (
        fused_train_stats_bl,
        fused_train_stats_bl_plain,
    )

    nu, free, noise_free, r, d_feat, hetero = case
    g = torch.Generator(device="cuda").manual_seed(4)
    B = 1000
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    # neighborhoods wide enough that t = sqrt(2 nu) u / ls crosses T0 = 2
    pts = torch.rand((n, 2, B), **opts) * 0.6
    q = torch.rand((2, B), **opts) * 0.6
    diff_p = pts[:, None] - pts[None, :]
    diff_c = pts - q[None]
    if d_feat:
        pw, cw, params = diff_p, diff_c, [0.3, 0.4]
    else:
        pw, cw = (diff_p**2).sum(2).sqrt(), (diff_c**2).sum(1).sqrt()
        params = [0.3]
    params = torch.tensor(params + [2e-2, 1e-2], device="cuda")
    y = torch.randn((n, r, B), **opts)
    noise_nn = torch.rand((n, B), **opts) * 1e-2 + 1e-2 if hetero else None
    args = [t.to(dtype).contiguous() if t is not None else None
            for t in (pw, cw, y, params, noise_nn)]
    kw = dict(gen_coeffs=_gen_coeffs(nu, dtype, train=True, need_dnu=free),
              smoothness="gen", noise_free=noise_free, smoothness_free=free,
              d_feat=d_feat)
    design = f"fused_train_stats/{k2_expected_design(n, r)}"
    before = dict(_build.launches)
    out = fused_train_stats_bl(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launches["fused_train_stats"] == before["fused_train_stats"] + 1
    assert _build.launches[design] == before[design] + 1
    ref = fused_train_stats_bl_plain(*args, **kw)
    G = d_feat if d_feat else 1
    assert out.shape[0] == (r + 2) + G * (r + 2) + (r + 1) + (r + 2) * free
    assert torch.isfinite(out).all()
    # f64: at an exact integer (mu clamped to 1e-7) the 1/mu-sized terms
    # cancel to ~1e-16 / 1e-7 relative; f32: a hundredth of the row
    rel = (1e-5 if nu == round(nu) else 1e-8) if dtype == torch.float64 else 1e-2
    for i, (err, mag) in enumerate(k2_row_errors(out, ref, r)):
        assert err <= rel * mag, f"row {i}: error {err} against {mag}"


def test_fused_chassis_on_the_card_matches_cpu():
    """Fused_L_BFGS_B_optimize through K2 on the card (f64) lands at the
    optimum of the same chassis on the CPU (K2's plain version), with one
    launch per objective evaluation."""
    _need_card()
    from muygpys_torch.convert import arrays_from_muygps, muygps_from_arrays
    from muygpys_torch.gpu import _build
    from muygpys_torch.optimize import Fused_L_BFGS_B_optimize

    rng = np.random.default_rng(3)
    B, n = 256, 20
    pts = rng.uniform(size=(B, n, 2))
    q = rng.uniform(size=(B, 2))
    pw = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    cw = np.sqrt(((q[:, None] - pts) ** 2).sum(-1))
    y = np.sin(3 * pts[..., 0]) + 0.1 * rng.standard_normal((B, n))
    t = np.sin(3 * q[:, 0]) + 0.1 * rng.standard_normal(B)
    out = {}
    for dev in ("cpu", "cuda"):
        model = muygps_from_arrays(
            0.5, noise=1e-3, smoothness=1.5, scale="analytic",
            length_scale_bounds=(0.01, 5.0), noise_bounds=(1e-6, 1.0),
        )
        iters = []
        _build.reset_launches()
        trained = Fused_L_BFGS_B_optimize(
            model, t, y, cw, pw, device=dev,
            callback=lambda xk: iters.append(1),
        )
        if dev == "cuda":
            assert _build.launches["fused_train_stats"] >= len(iters) + 1
        out[dev] = arrays_from_muygps(trained)
    np.testing.assert_allclose(
        out["cuda"]["length_scale"], out["cpu"]["length_scale"], rtol=1e-6
    )
    np.testing.assert_allclose(
        out["cuda"]["noise"], out["cpu"]["noise"], rtol=1e-6
    )


def test_free_nu_objective_builds_its_coefficients_on_the_card(monkeypatch):
    """The free-smoothness K2 objective on the card: the coefficient vector
    is built from a tensor on the card at every evaluation, and value and
    gradients equal the same objective on the CPU (K2's plain version, the
    same constructor there) in f64."""
    _need_card()
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.gpu import matern_nu
    from muygpys_torch.optimize import fused_objective

    built = []

    def counting(nu, need_dnu=False):
        built.append(nu.device.type)
        return matern_nu.matern_nu_coeffs(nu, need_dnu=need_dnu)

    monkeypatch.setattr(fused_objective, "matern_nu_coeffs", counting)
    rng = np.random.default_rng(5)
    B, n = 128, 12
    pts = rng.uniform(size=(B, n, 2))
    q = rng.uniform(size=(B, 2))
    pw = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    cw = np.sqrt(((q[:, None] - pts) ** 2).sum(-1))
    y = np.sin(3 * pts[..., 0]) + 0.1 * rng.standard_normal((B, n))
    t = np.sin(3 * q[:, 0]) + 0.1 * rng.standard_normal(B)
    at = {"length_scale": 0.4, "noise": 2e-3, "smoothness": 1.81}
    got = {}
    for dev in ("cpu", "cuda"):
        model = muygps_from_arrays(
            0.5, noise=1e-3, smoothness=1.2, smoothness_bounds=(0.31, 5.0),
            length_scale_bounds=(0.01, 5.0), noise_bounds=(1e-6, 1.0),
            scale="analytic",
        )
        obj, names = fused_objective.make_fused_train_objective(
            model, t, y, cw, pw, device=dev
        )
        del built[:]
        before = _build.launches["fused_train_stats"]
        value, grads = obj(at)
        assert built == [dev]
        assert _build.launches["fused_train_stats"] == before + (dev == "cuda")
        assert value.device.type == dev
        got[dev] = [float(value)] + [float(grads[k]) for k in names]
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-7)


# -- K5: the fused multi-output block solve ----------------------------------


def _shear_blocks(B, I, n, dtype, seed=0, ls=0.05):
    """Real shear blocks in the frontend layout, as the serving path
    assembles them: neighbours scattered 0.03 around each query, nugget 1e-3
    of the prior diagonal."""
    from muygpys_torch.convert import muygps_from_arrays

    rng = np.random.default_rng(seed)
    q = rng.uniform(size=(B, 2))
    nf = q[:, None, :] + 0.03 * rng.standard_normal((B, n, 2))
    y = rng.standard_normal((B, I, n))
    model = muygps_from_arrays(
        ls, noise=1e-3 * 2 / ls**4,
        kernel="shear" if I == 3 else "shear_2in3out",
        noise_model="shear33" if I == 3 else "homoscedastic",
    )
    nf_d = torch.as_tensor(nf, device="cuda").to(dtype)
    q_d = torch.as_tensor(q, device="cuda").to(dtype)
    pw = nf_d[:, :, None, :] - nf_d[:, None, :, :]
    cw = q_d[:, None, :] - nf_d
    Kin = model.noise.perturb(model.kernel(pw))
    return (Kin, model.kernel(cw),
            model.kernel.Kout().to(dtype=dtype, device="cuda"),
            torch.as_tensor(y, device="cuda").to(dtype))


# K5 against its plain version, as fractions of the largest |mean| and of
# the prior diagonal (800).  Measured on an H100 at the serving shape: f32
# mean 9.5e-7 absolute, covariance 1.2e-4 = 1.5e-7 of the prior; f64 2.0e-15
# and 3.4e-13.  These shapes differ from that one, so the limits sit ~100x
# above those spreads
K5_REL = {torch.float64: (1e-11, 1e-12), torch.float32: (1e-4, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "I,n,B", [(3, 30, 257), (2, 30, 64), (3, 20, 65), (3, 8, 1000)]
)
def test_k5_kernel_matches_plain_in_both_layouts(I, n, B, dtype):
    """m = 90, and m = 60 (3 x 20 and 2 x 30) in f32, through the register
    design; m = 60 in f64 and m = 24 through the shared-memory design, as
    the launcher picks them."""
    _need_card()
    from muygpys_torch.gpu import multiout_solve as K5
    from muygpys_torch.ops.lanes_solver import multiout_frontend_bl

    Kin, Kc, Kout, y = _shear_blocks(B, I, n, dtype)
    design = "multiout_solve/" + K5.multiout_design(I * n, 3, dtype)
    registers = I * n == 90 or (I * n == 60 and dtype == torch.float32)
    assert design.endswith("registers" if registers else "shared")
    before = dict(_build.launches)
    mean_f, cov_f = K5.multiout_serve_cuda(Kin, Kc, Kout, y)
    Kin_bl, Kc_bl, y_bl = multiout_frontend_bl(Kin, Kc, y)
    mean_b, cov_b = K5.fused_multiout_solve_bl(Kin_bl, Kc_bl, Kout, y_bl)
    torch.cuda.synchronize()
    assert _build.launches["multiout_solve"] == before["multiout_solve"] + 2
    assert _build.launches[design] == before[design] + 2
    mean_p, cov_p = K5.fused_multiout_solve_bl_plain(Kin_bl, Kc_bl, Kout, y_bl)
    assert mean_f.shape == (B, 3) and cov_f.shape == (B, 3, 3)
    assert mean_b.shape == (3, B) and cov_b.shape == (3, 3, B)
    # one kernel, two sets of strides: the same arithmetic, bit for bit
    assert torch.equal(mean_f, mean_b.T)
    assert torch.equal(cov_f, cov_b.permute(2, 0, 1))
    rel_m, rel_c = K5_REL[dtype]
    m_scale = float(mean_p.abs().max())
    c_scale = float(Kout.diagonal().max())
    assert float((mean_b - mean_p).abs().max()) <= rel_m * m_scale
    assert float((cov_b - cov_p).abs().max()) <= rel_c * c_scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [8, 20])
def test_k5_singular_block_stays_finite(n, dtype):
    """A block made singular by duplicated rows, through the shared-memory
    design (m = 24; m = 60 in f64) and the register design (m = 60 in f32):
    every output finite,
    the other blocks at the ordinary limit, the singular one close to the
    plain version's (huge) numbers."""
    _need_card()
    from muygpys_torch.gpu import multiout_solve as K5
    from muygpys_torch.ops.lanes_solver import multiout_frontend_bl

    rng = np.random.default_rng(3)
    B, I, O = 16, 3, 3
    m = I * n
    A = rng.standard_normal((B, m, 2 * m))
    flat = A @ A.transpose(0, 2, 1) / (2 * m) + 0.5 * np.eye(m)
    flat[3, 5, :] = flat[3, 4, :]
    flat[3, :, 5] = flat[3, :, 4]
    Kin = torch.as_tensor(flat.reshape(B, I, n, I, n), device="cuda").to(dtype)
    Kc = torch.as_tensor(rng.standard_normal((B, I, n, O)), device="cuda").to(dtype)
    y = torch.as_tensor(rng.standard_normal((B, I, n)), device="cuda").to(dtype)
    Kout = torch.eye(O, device="cuda", dtype=dtype) * 1.3 + 0.1
    mean, cov = K5.multiout_serve_cuda(Kin, Kc, Kout, y)
    torch.cuda.synchronize()
    mean_p, cov_p = K5.fused_multiout_solve_bl_plain(
        *multiout_frontend_bl(Kin, Kc, y)[:2], Kout, y.reshape(B, m).T
    )
    mean_p, cov_p = mean_p.T, cov_p.permute(2, 0, 1)
    assert torch.isfinite(mean).all() and torch.isfinite(cov).all()
    ok = [b for b in range(B) if b != 3]
    # measured on an H100: 1.1e-14 (f64) and 3.8e-6 (f32) absolute
    tol = 1e-11 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(mean[ok], mean_p[ok], rtol=tol, atol=tol)
    torch.testing.assert_close(cov[ok], cov_p[ok], rtol=tol, atol=tol)
    # the floored pivot is the same number on both sides, and row 5's
    # right-hand sides are the O(1) difference of rows 5 and 4 divided by
    # sqrt(floor): huge, but as well determined as any other block's
    assert float(mean_p[3].abs().max()) > 1e3
    # (measured 2.2e-16 and 2.8e-8 relative)
    rel = 1e-11 if dtype == torch.float64 else 1e-5
    assert float((mean[3] - mean_p[3]).abs().max()) <= rel * float(mean_p[3].abs().max())
    assert float((cov[3] - cov_p[3]).abs().max()) <= rel * float(cov_p[3].abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k5_both_designs_agree_at_m90(dtype):
    """The shared-memory design, forced at a register shape, agrees with
    the register design (the same arithmetic in another order); the
    register kernel refuses a shape it was not compiled for."""
    _need_card()
    from muygpys_torch.gpu import multiout_solve as K5

    Kin, Kc, Kout, y = _shear_blocks(129, 3, 30, dtype, seed=4)
    B, m = Kin.shape[0], 90
    args = (Kin.reshape(B, m, m), Kc.reshape(B, m, 3), y.reshape(B, m),
            m, 3, B, False)
    mr, Sr = K5._launch(*args, design="registers")
    ms, Ss = K5._launch(*args, design="shared")
    torch.cuda.synchronize()
    rel_m, rel_c = K5_REL[dtype]
    assert float((mr - ms).abs().max()) <= rel_m * float(ms.abs().max())
    assert float((Sr - Ss).abs().max()) <= rel_c * float(Kout.diagonal().max())
    small = _shear_blocks(4, 3, 8, dtype)
    with pytest.raises(RuntimeError, match="CUDA error"):
        K5._launch(small[0].reshape(4, 24, 24), small[1].reshape(4, 24, 3),
                   small[3].reshape(4, 24), 24, 3, 4, False, design="registers")


def test_k5_launcher_refuses_what_does_not_fit():
    _need_card()
    from muygpys_torch.gpu import multiout_solve as K5

    m = 239  # one query's f32 matrix is over the 227 KB a block can use
    Kin = torch.eye(m, device="cuda")[None].repeat(2, 1, 1).reshape(2, 1, m, 1, m)
    with pytest.raises(ValueError, match="shared memory"):
        K5.multiout_serve_cuda(
            Kin, torch.zeros((2, 1, m, 3), device="cuda"),
            torch.eye(3, device="cuda"), torch.zeros((2, 1, m), device="cuda"),
        )
    # the largest f32 shape that fits launches, with the opt-in above 48 KB
    m = 238
    Kin = torch.eye(m, device="cuda")[None].repeat(2, 1, 1).reshape(2, 1, m, 1, m)
    mean, cov = K5.multiout_serve_cuda(
        Kin, torch.ones((2, 1, m, 3), device="cuda"),
        torch.eye(3, device="cuda") * 300, torch.ones((2, 1, m), device="cuda"),
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(mean, torch.full((2, 3), float(m), device="cuda"))
    torch.testing.assert_close(
        cov, (torch.eye(3, device="cuda") * 300 - m)[None].repeat(2, 1, 1)
    )


@pytest.mark.parametrize("family", ["33", "23"])
def test_shear_server_kernel_engine_on_the_card(family):
    """FastServer(engine="kernel") on the card launches K5 once per bucket
    and agrees with the lanes engine on the same neighbours."""
    _need_card()
    from muygpys_torch import config
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    rng = np.random.default_rng(5)
    pts = rng.uniform(size=(3000, 2)).astype(np.float32)
    phase = pts @ (2 * np.pi * np.array([3.0, 5.0], dtype=np.float32))
    targets = np.stack(
        [np.sin(phase), 0.4 * np.cos(phase), 0.3 * np.sin(2 * phase)], axis=1
    )
    obs = targets if family == "33" else targets[:, 1:]
    ls = 0.05
    model = muygps_from_arrays(
        ls, noise=1e-3 * 2 / ls**4,
        kernel="shear" if family == "33" else "shear_2in3out",
        noise_model="shear33" if family == "33" else "homoscedastic",
    )
    xte = rng.uniform(size=(300, 2)).astype(np.float32)
    nbrs = NN_Wrapper(pts, 30)
    old = config.state.ftype
    try:
        config.update("ftype", 64)
        before = _build.launches["multiout_solve"]
        m64, c64 = FastServer(model, nbrs, pts, obs, bucket=128,
                              engine="kernel").predict(xte)
        assert _build.launches["multiout_solve"] == before + 3
        ml, cl = FastServer(model, nbrs, pts, obs, bucket=128,
                            engine="lanes").predict(xte)
        config.update("ftype", 32)
        m32, c32 = FastServer(model, nbrs, pts, obs, bucket=128,
                              engine="kernel").predict(xte)
    finally:
        config.update("ftype", old)
    assert m64.shape == (300, 3) and c64.shape == (300, 3, 3)
    np.testing.assert_allclose(m64, ml, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(c64, cl, rtol=1e-8, atol=1e-7)
    # f32 against f64: at the 50,000-point sky the mean is 1.0e-6 off and
    # the covariance 1.9e-7 of the prior diagonal (H100); this smaller sky
    # has wider neighbourhoods, so the limits sit well above that
    prior = 2 / ls**2
    assert np.abs(m32 - ml).max() <= 1e-3 * np.abs(ml).max()
    assert np.abs(c32 - cl).max() <= 1e-4 * prior
