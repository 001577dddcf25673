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
from muygpys_torch.gpu import matern_nu as tm
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
    before = dict(_build.launches)
    mk, vk = fused_predict_coords_bl(
        nf, q, y, params, noise_nn, smoothness=smoothness, metric_power=power
    )
    assert _build.launches["fused_predict_coords"] == (
        before["fused_predict_coords"] + 1)
    assert _build.launches["fused_predict_coords/gen"] == (
        before["fused_predict_coords/gen"])
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
    before = dict(_build.launches)
    mk, vk = fused_predict_coords_bl(
        nf, q, y, params, noise_nn, gen_coeffs=co, smoothness="gen"
    )
    torch.cuda.synchronize()
    for name in ("fused_predict_coords", "fused_predict_coords/gen"):
        assert _build.launches[name] == before[name] + 1, name
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


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("bins,k", [(256, 30), (512, 38), (1024, 62)])
def test_k3_fused_design_matches_plain(pruned, bins, k):
    """The fused K3 design (the merge inside the kernel; pruned, its
    bounded route) against knn_select_plain: distances bit-equal (both in
    ascending key order), index sets equal on at least 0.999 of slots (ties
    between equal keys may order differently); the launcher picks it and
    counts it."""
    _need_card()
    rng = np.random.default_rng(1)
    train = torch.as_tensor(rng.uniform(size=(20000, 2)), dtype=torch.float32,
                            device="cuda")
    queries = torch.as_tensor(rng.uniform(size=(1000, 2)),
                              dtype=torch.float32, device="cuda")
    train = train[K.spatial_sort(train)].contiguous()
    prep = (K.prepare_bounded(train, queries, k, bins=bins) if pruned
            else K.prepare(train, queries, k, bins=bins))
    assert K.knn_design(2, k, bins) == "fused"
    before = _build.launches["knn_candidates/fused"]
    idx, d2 = K.knn_select(prep, k)
    torch.cuda.synchronize()
    assert _build.launches["knn_candidates/fused"] == before + 1
    ip, dp = K.knn_select_plain(prep, k)
    assert torch.equal(d2, dp)
    same = (torch.sort(idx, 1).values == torch.sort(ip, 1).values)
    assert float(same.float().mean()) >= 0.999
    ik, dk = K.knn_select(prep, k, design="keys")
    assert torch.equal(dk, dp)


@pytest.mark.parametrize("k", [38, 9])
def test_k3_bounded_route_is_the_unpruned_kernel_at_the_cells_shape(k):
    """K3p's bounded route at the serving cells' shape (8192 uniform queries
    x 10^6 uniform Morton-sorted rows, 512 bins; k = 38 the bulk bucket's
    candidates, 9 the fast-mean bucket's): idx and d2 bit-equal to the
    unpruned fused kernel's on the same sorted queries, one launch counted
    as K3p and no subsample search, a strict minority of boxes walked; and
    knn_cuda_pruned through it equals knn_cuda bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(18)
    train = torch.rand((1_000_000, 2), device="cuda", generator=g)
    train = train[K.spatial_sort(train)].contiguous()
    queries = torch.rand((8192, 2), device="cuda", generator=g)
    index = K.build_index(train, pruned=True)
    assert index.boxes.norm.shape[0] == 3912
    prep = K.prepare_bounded(None, queries, k, train_index=index)
    _build.reset_launches()
    idx, d2 = K.knn_select(prep, k)
    torch.cuda.synchronize()
    assert _build.launches["knn_candidates_pruned"] == 1
    assert _build.launches["knn_candidates"] == 0
    total, scored = index.boxes.counts.tolist()
    assert total == 1024 * 3912 and 1024 <= scored and 2 * scored < total
    ik, dk = K.knn_select(K.prepare(train, prep.q, k, query_tile=8), k)
    assert torch.equal(idx, ik) and torch.equal(d2, dk)
    _build.reset_launches()
    i1, d1 = K.knn_cuda_pruned(None, queries, k, train_index=index)
    torch.cuda.synchronize()
    assert _build.launches["knn_candidates_pruned"] == 1
    assert _build.launches["knn_candidates"] == 0
    i0, d0 = K.knn_cuda(train, queries, k)
    assert torch.equal(i1, i0) and torch.equal(d1, d0)


@pytest.mark.parametrize(
    "count,d,cluster",
    [(8192, 2, False), (256, 2, False), (1, 2, False), (8191, 3, False),
     (4096, 4, False), (256, 2, True)],
)
def test_query_order_kernel_is_the_plain_route(count, d, cluster):
    """The bounded route's query order on the card (one launch of
    knn_query_order_kernel) gives the plain route's sorted, edge-padded
    queries, permutation and inverse bit for bit: uniform queries, and
    (cluster) queries in a cube of side 0.01 as the small cell's."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(count + d)
    q = torch.rand((count, d), device="cuda", generator=g)
    if cluster:
        q = 0.99 * torch.rand(d, device="cuda", generator=g) + 0.01 * q
    _build.reset_launches()
    q_pad, qperm, qinv = K.knn_query_order(q)
    torch.cuda.synchronize()
    assert _build.launches["knn_query_order"] == 1
    assert _build.launches["knn_query_order/torch"] == 0
    want_pad, want_perm = K._sorted_queries(q, 8)
    assert torch.equal(q_pad, want_pad) and torch.equal(qperm, want_perm)
    assert torch.equal(qinv, torch.argsort(want_perm))


def test_query_order_past_the_cap_is_plain_pytorch():
    """Past ORDER_CAP queries the order is the plain route's, counted as
    left to PyTorch."""
    _need_card()
    q = torch.rand((K.ORDER_CAP + 1, 2), device="cuda")
    _build.reset_launches()
    q_pad, qperm, qinv = K.knn_query_order(q)
    torch.cuda.synchronize()
    assert _build.launches["knn_query_order"] == 0
    assert _build.launches["knn_query_order/torch"] == 1
    want_pad, want_perm = K._sorted_queries(q, 8)
    assert torch.equal(q_pad, want_pad) and torch.equal(qperm, want_perm)
    assert torch.equal(qinv, torch.argsort(want_perm))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("smoothness", [1.5, "gen"])
def test_k1_both_designs_agree_and_registers_refuse_n33(smoothness, dtype):
    """Both K1 designs against the plain version at n = 30; the register
    design refuses n = 33 (the launcher then takes shared memory)."""
    _need_card()
    from muygpys_torch.gpu import fused_predict as F
    from muygpys_torch.gpu import matern_nu as _nu

    g = torch.Generator(device="cuda").manual_seed(4)
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    co = _gen_coeffs(1.2, dtype) if smoothness == "gen" else None
    for n in (30, 33):
        nf = (torch.rand((n, 2, 999), **opts) * 0.3).to(dtype)
        q = (torch.rand((2, 999), **opts) * 0.3).to(dtype)
        y = torch.randn((n, 1, 999), **opts).to(dtype)
        params = torch.tensor([0.5, 0.7, 1e-3], dtype=dtype, device="cuda")
        code = _nu.check_smoothness("k1", smoothness, co, 1, _nu._LEN_VAL)
        gen = None if co is None else co[:_nu._LEN_VAL].contiguous()
        mp, vp = F.fused_predict_coords_bl_plain(
            nf, q, y, params, gen_coeffs=co, smoothness=smoothness)
        tol_m, tol_v = K1_TOL[dtype]
        for design in ("registers", "shared"):
            if n == 33 and design == "registers":
                with pytest.raises(RuntimeError, match="launch failed"):
                    F._launch(nf, q, y, params, None, gen, code, 1,
                              smoothness, design=design)
                continue
            m, v = F._launch(nf, q, y, params, None, gen, code, 1, smoothness,
                             design=design)
            torch.testing.assert_close(m, mp, rtol=0, atol=tol_m * 10)
            torch.testing.assert_close(v, vp, rtol=0, atol=tol_v * 10)
        assert F.k1_design(n, 1, dtype, smoothness) == (
            "registers" if n <= 32 else "shared")


def test_launchers_enter_the_tensors_device():
    """With cuda:0 current, a server and a training run on cuda:1 launch
    on cuda:1 (K3, K1, K2) and agree with the same work on cuda:0."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from muygpys_torch.convert import arrays_from_muygps, muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.optimize import Fused_L_BFGS_B_optimize
    from muygpys_torch.serve import FastServer

    rng = np.random.default_rng(6)
    train = rng.uniform(size=(5000, 2)).astype(np.float32)
    targets = np.sin(6 * train[:, :1]).astype(np.float32)
    queries = rng.uniform(size=(700, 2)).astype(np.float32)
    model = muygps_from_arrays(0.3, noise=1e-3, smoothness=1.5)
    B, n = 128, 20
    pts = rng.uniform(size=(B, n, 2))
    q = rng.uniform(size=(B, 2))
    pw = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    cw = np.sqrt(((q[:, None] - pts) ** 2).sum(-1))
    y = np.sin(3 * pts[..., 0])
    t = np.sin(3 * q[:, 0])
    out = {}
    torch.cuda.set_device(0)
    for dev in ("cuda:0", "cuda:1"):
        _build.reset_launches()
        nbrs = NN_Wrapper(train, 20, nn_method="kernel", device=dev)
        server = FastServer(model, nbrs, train, targets, bucket=256,
                            engine="fused", device=dev)
        mean, var = server.predict(queries)
        trained = Fused_L_BFGS_B_optimize(
            muygps_from_arrays(
                0.5, noise=1e-3, smoothness=1.5, scale="analytic",
                length_scale_bounds=(0.01, 5.0), noise_bounds=(1e-6, 1.0),
            ),
            t, y, cw, pw, device=dev,
        )
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
        for name in ("knn_candidates/fused", "fused_predict_coords",
                     "fused_train_stats"):
            assert _build.launches[name] > 0, name
        out[dev] = (mean, var, arrays_from_muygps(trained)["length_scale"],
                    nbrs.get_nns(queries)[0])
    np.testing.assert_array_equal(out["cuda:0"][3], out["cuda:1"][3])
    np.testing.assert_allclose(out["cuda:0"][0], out["cuda:1"][0], atol=1e-6)
    np.testing.assert_allclose(out["cuda:0"][1], out["cuda:1"][1], atol=1e-7)
    np.testing.assert_allclose(out["cuda:0"][2], out["cuda:1"][2], rtol=1e-5)


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


# -- K4's constructor: the coefficient vector in one launch -----------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("need_dnu", [False, True])
@pytest.mark.parametrize("nu", tm.COEFFS_CHECK_NUS)
def test_k4_constructor_kernel_matches_plain(nu, need_dnu, dtype):
    """matern_nu_coeffs on a CUDA nu is one launch of the constructor
    kernel and gives the plain version's vector on the same card."""
    _need_card()
    t = torch.tensor(nu, dtype=dtype, device="cuda")
    before = _build.launches["matern_nu_coeffs"]
    got = tm.matern_nu_coeffs(t, need_dnu)
    torch.cuda.synchronize()
    assert _build.launches["matern_nu_coeffs"] == before + 1
    want = tm.matern_nu_coeffs_plain(t, need_dnu)
    assert got.dtype == dtype and got.device == t.device
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs().double().cpu().numpy()
    limits = tm.coeffs_limits(want, tm.COEFFS_CHECK_RTOL[dtype])
    assert (err <= limits).all(), float((err / limits).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_constructor_is_differentiable_on_the_card(dtype):
    """Reverse mode through the kernel's vector (the tangent the same
    launch writes) matches reverse mode through the plain version."""
    _need_card()
    t = torch.tensor([0.7, 3.0], dtype=dtype, device="cuda")
    grads = {}
    for build in (tm.matern_nu_coeffs, tm.matern_nu_coeffs_plain):
        nu = torch.tensor(1.7, dtype=dtype, device="cuda", requires_grad=True)
        tm.matern_nu_eval(t, build(nu)).sum().backward()
        grads[build.__name__] = float(nu.grad)
    rtol = 1e-9 if dtype == torch.float64 else 1e-3
    assert grads["matern_nu_coeffs"] == pytest.approx(
        grads["matern_nu_coeffs_plain"], rel=rtol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_digamma_kernel_matches_torch(dtype):
    """The constructor's device digamma against torch.special.digamma on
    the card."""
    _need_card()
    import ctypes

    x = torch.cat([torch.linspace(0.01, 30.0, 997, dtype=torch.float64),
                   torch.tensor([1.0, 9.999, 10.0, 10.001, 1e3, 1e6, -0.5,
                                 -2.25, -7.9], dtype=torch.float64)])
    x = x.to(dtype).cuda()
    out = torch.full_like(x, math.nan)
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _build.function("matern_nu_coeffs", f"matern_nu_digamma_{suffix}",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(out), x.numel(),
                    _build.stream(x.device)), "matern_nu_coeffs", "digamma")
    rtol = {torch.float64: 1e-14, torch.float32: 4e-6}[dtype]
    torch.testing.assert_close(out, torch.special.digamma(x), rtol=rtol,
                               atol=rtol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("smoothness", [1.5, "gen"])
def test_k1b_both_designs_read_both_triangles_and_registers_refuse_n33(
        smoothness, dtype):
    """Both K1b designs against the plain version on a pw whose upper
    triangle differs from its lower one; the register design refuses
    n = 33 (the launcher then takes shared memory)."""
    _need_card()
    from muygpys_torch.gpu import fused_predict as F
    from muygpys_torch.gpu import matern_nu as _nu

    g = torch.Generator(device="cuda").manual_seed(8)
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    co = _gen_coeffs(1.2, dtype) if smoothness == "gen" else None
    for n in (30, 33):
        B = 1001
        pts = torch.rand((n, 2, B), **opts)
        q = torch.rand((2, B), **opts)
        pw = ((pts[:, None] - pts[None, :]) ** 2).sum(2).sqrt()
        upper = torch.triu(torch.ones((n, n), **{k: opts[k] for k in
                                                 ("dtype", "device")}), 1)
        pw = pw * (1.0 + 0.1 * upper[:, :, None] * torch.rand((n, n, B), **opts))
        cw = ((pts - q[None]) ** 2).sum(1).sqrt()
        y = torch.randn((n, 1, B), **opts)
        args = [t.to(dtype).contiguous() for t in (pw, cw, y)]
        params = torch.tensor([0.6, 0.1], dtype=dtype, device="cuda")
        code = _nu.check_smoothness("k1b", smoothness, co, 1, _nu._LEN_VAL)
        gen = None if co is None else co[:_nu._LEN_VAL].contiguous()
        mp, vp = F.fused_predict_bl_plain(*args, params, gen_coeffs=co,
                                          smoothness=smoothness)
        tol_m, tol_v = K1_TOL[dtype]
        for design in ("registers", "shared"):
            if n == 33 and design == "registers":
                with pytest.raises(RuntimeError, match="launch failed"):
                    F._launch_dists(*args, params, gen, code, 1, smoothness,
                                    design=design)
                continue
            before = _build.launches[f"fused_predict/{design}"]
            m, v = F._launch_dists(*args, params, gen, code, 1, smoothness,
                                   design=design)
            torch.cuda.synchronize()
            assert _build.launches[f"fused_predict/{design}"] == before + 1
            torch.testing.assert_close(m, mp, rtol=0, atol=tol_m)
            torch.testing.assert_close(v, vp, rtol=0, atol=tol_v)
        assert F.k1_design(n, 1, dtype, smoothness) == (
            "registers" if n <= 32 else "shared")


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
    (the replays of its captured bucket, plus the eager warm-up before the
    capture) and agrees with the lanes engine on the same neighbours."""
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
        assert _build.launches["multiout_solve"] == before + 1 + 3
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


# ---------------------------------------------------------------------------
# captured programs: serving buckets and the device chassis


def _fused_field(seed=11, count=4096, d=2):
    rng = np.random.default_rng(seed)
    train = rng.uniform(size=(count, d)).astype(np.float32)
    targets = rng.standard_normal((count, 1)).astype(np.float32)
    queries = rng.uniform(size=(700, d)).astype(np.float32)
    return train, targets, queries


def _captured_and_eager(server, requests):
    """Each request's outputs through the captured bucket, and the eager
    core's on the same padded inputs, with the launches of each (the
    captured program already exists: the caller warmed the server up).
    The index's own search (the exact kernel, run by ``predict`` before
    the bucket and outside its graph) is not the bucket's launch."""
    out = []
    for req in requests:
        _build.reset_launches()
        m, v = server.predict(req)
        captured = dict(_build.launches, knn_exact_select=0)
        inputs = server._captured.inputs  # the bucket just served
        _build.reset_launches()
        me, ve = server._core(*inputs)
        eager = dict(_build.launches)
        out.append(((m, v), (me.cpu().numpy(), ve.cpu().numpy()),
                    captured, eager))
    return out


@pytest.mark.parametrize("engine", ["fused", "kernel"])
def test_captured_serving_is_bit_equal_to_the_eager_core(engine):
    """A served bucket replays the graph captured at the first bucket: its
    outputs equal the eager core's on the same inputs bit for bit, and it
    launches the same kernels the same number of times."""
    _need_card()
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    train, targets, queries = _fused_field()
    model = muygps_from_arrays(0.3, noise=1e-3, smoothness=1.5, scale=1.0)
    server = FastServer(model, NN_Wrapper(train, 30), train, targets,
                        bucket=256, engine=engine)
    server.predict(queries[:10])  # the capture
    assert server._captured is not None
    # one bucket each, the second padded
    for (m, v), (me, ve), captured, eager in _captured_and_eager(
        server, [queries[:256], queries[256:400]]
    ):
        n = len(m)
        assert np.array_equal(m, me[:n]) and np.array_equal(v, ve[:n])
        assert captured == eager and eager["fused_predict_coords"] == 1
        if engine == "fused":
            assert eager["knn_candidates_pruned"] == 1
            assert eager["knn_candidates"] == 0  # no subsample search
    if engine == "fused":
        stats = server.search_stats()
        assert 0 < 2 * stats["boxes_scored"] < stats["boxes_total"]


def test_captured_fast_mean_is_bit_equal_to_the_eager_core():
    """The fast_mean engine's bucket replays the graph captured at the
    first bucket: its means equal the eager core's on the same inputs bit
    for bit, with the same launches, K3 pruned once a bucket; the
    precompute's state is finite and agrees with the CPU's."""
    _need_card()
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    train, targets, queries = _fused_field()
    model = muygps_from_arrays(0.3, noise=1e-3, smoothness=1.5, scale=1.0)
    server = FastServer(model, NN_Wrapper(train, 30, nn_method="exact"),
                        train, targets, bucket=256, engine="fast_mean")
    assert server.precompute["points"] == len(train)
    assert server.precompute["failed"] == 0
    mean, none = server.predict(queries[:10])  # the capture
    assert none is None and mean.shape == (10, 1)
    assert server.mode == "captured" and server._captured is not None
    for req in (queries[:256], queries[256:400]):
        _build.reset_launches()
        m, _ = server.predict(req)
        captured = dict(_build.launches)
        inputs = server._captured.inputs
        _build.reset_launches()
        (me,) = server._core(*inputs)
        eager = dict(_build.launches)
        assert np.array_equal(m, me.cpu().numpy()[:len(m)])
        assert captured == eager and eager["knn_candidates_pruned"] == 1
        assert eager["knn_candidates"] == 0  # no subsample search
    stats = server.search_stats()
    assert 0 < 2 * stats["boxes_scored"] < stats["boxes_total"]
    cpu = FastServer(model, NN_Wrapper(train, 30, device="cpu"), train,
                     targets, bucket=256, engine="fast_mean", device="cpu")
    # f32 on both sides: the coefficients' rounding times the conditioning
    # (noise 1e-3), as the fast-mean card test above allows
    np.testing.assert_allclose(m, cpu.predict(queries[256:400])[0],
                               atol=5e-3)


def test_captured_shear_serving_is_bit_equal_to_the_eager_core():
    _need_card()
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    rng = np.random.default_rng(5)
    pts = rng.uniform(size=(3000, 2)).astype(np.float32)
    phase = pts @ (2 * np.pi * np.array([3.0, 5.0], dtype=np.float32))
    targets = np.stack(
        [np.sin(phase), 0.4 * np.cos(phase), 0.3 * np.sin(2 * phase)], axis=1
    )
    ls = 0.05
    model = muygps_from_arrays(ls, noise=1e-3 * 2 / ls**4, kernel="shear",
                               noise_model="shear33")
    server = FastServer(model, NN_Wrapper(pts, 30), pts, targets,
                        bucket=128, engine="kernel")
    xte = rng.uniform(size=(300, 2)).astype(np.float32)
    server.predict(xte[:5])
    for (m, c), (me, ce), captured, eager in _captured_and_eager(
        server, [xte[:128], xte[128:256]]
    ):
        assert np.array_equal(m, me) and np.array_equal(c, ce)
        assert captured == eager and eager["multiout_solve"] == 1



def test_program_spans_stay_off_the_device_timeline():
    """Under a CPU + CUDA profiler around a server's capture and a request
    of two replayed buckets, the program's spans are host ``cpu_op``
    events: none shows on the device's timeline (a ``record_function``
    span would), and the capture is one ``muygpys.graph.capture`` span."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.serve import FastServer

    train, targets, queries = _fused_field()
    model = muygps_from_arrays(0.3, noise=1e-3, smoothness=1.5, scale=1.0)
    server = FastServer(model, NN_Wrapper(train, 30), train, targets,
                        bucket=256, engine="kernel")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        server.predict(queries[:10])  # the capture
        server.predict(queries[:300])
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    assert any(e.device_type() == cuda for e in events)
    assert [e.name() for e in events if e.device_type() == cuda
            and e.name().startswith("muygpys.")] == []
    names = [e.name() for e in events if e.name().startswith("muygpys.")]
    assert names.count("muygpys.graph.capture") == 1
    assert names.count("muygpys.serve.predict") == 2
    assert names.count("muygpys.serve.replay") == 3
    assert names.count("muygpys.nn.get_nns") == 2
    assert server.stats["buckets"] == 3 and server.stats["padded"] == 458

def _train_problem(seed=3, B=256, n=20):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(B, n, 2))
    q = rng.uniform(size=(B, 2))
    pw = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    cw = np.sqrt(((q[:, None] - pts) ** 2).sum(-1))
    y = np.sin(3 * pts[..., 0]) + 0.1 * rng.standard_normal((B, n))
    t = np.sin(3 * q[:, 0]) + 0.1 * rng.standard_normal(B)
    return t, y, cw, pw


def _train_model():
    from muygpys_torch.convert import muygps_from_arrays

    return muygps_from_arrays(
        0.5, noise=1e-3, smoothness=1.5, scale="analytic",
        length_scale_bounds=(0.01, 5.0), noise_bounds=(1e-6, 1.0),
    )


def test_device_chassis_replays_and_reads_done_once_per_replay():
    """Fused_Device_LBFGS_optimize through K2 on the card (f64): one eager
    warm-up step, then replays of one captured graph from the start, each
    followed by one read of the done flag; K2 ran at every step of every
    replay; the optimum is the same chassis' on the CPU."""
    _need_card()
    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.optimize import Fused_Device_LBFGS_optimize
    from muygpys_torch.optimize.device_chassis import STEPS_PER_REPLAY

    data = _train_problem()
    out = {}
    for dev in ("cpu", "cuda"):
        info = {}
        _build.reset_launches()
        out[dev] = arrays_from_muygps(Fused_Device_LBFGS_optimize(
            _train_model(), *data, device=dev, info=info
        ))
        out[dev + "_info"] = info
    info = out["cuda_info"]
    assert info["replays"] == math.ceil(
        info["evaluations"] / STEPS_PER_REPLAY
    )
    assert info["capture_ms"] > 0
    assert (_build.launches["fused_train_stats"]
            == 1 + info["replays"] * STEPS_PER_REPLAY)
    assert info["iterations"] == out["cpu_info"]["iterations"]
    for key in ("length_scale", "noise"):
        np.testing.assert_allclose(out["cuda"][key], out["cpu"][key],
                                   rtol=1e-6)


def test_a_failed_capture_raises():
    """An objective that reads the device back to the host cannot be
    captured: the device chassis raises instead of stepping eagerly."""
    _need_card()
    from muygpys_torch.optimize import device_lbfgs

    def fun(z):
        return torch.sum((z - 1.0) ** 2) * (1.0 + 0.0 * float(z[0]))

    with pytest.raises(RuntimeError):
        device_lbfgs(fun, torch.zeros(2, dtype=torch.float64, device="cuda"))


def test_device_lbfgs_puts_a_numpy_start_on_the_card():
    """A z0 that is not a tensor runs on the card, replayed from a captured
    graph, as does lbfgs_while_loop; both agree with the CPU's steps."""
    _need_card()
    from muygpys_torch.optimize import device_chassis as tdc

    def fun(z):
        w = torch.arange(1.0, 4.0, dtype=z.dtype, device=z.device)
        return torch.sum(w * (z - 0.5) ** 2) + 0.1 * torch.sum(z ** 4)

    z0 = np.array([1.0, -2.0, 0.3])
    z, info = tdc.device_lbfgs(fun, z0)
    assert z.device.type == "cuda" and info["capture_ms"] > 0
    ref, ref_info = tdc.device_lbfgs(fun, z0, device="cpu")
    assert info["iterations"] == ref_info["iterations"]
    np.testing.assert_allclose(z.cpu().numpy(), ref.numpy(), rtol=1e-10)
    out = tdc.lbfgs_while_loop(fun, list(z0))
    assert all(t.device.type == "cuda" for t in out)
    np.testing.assert_allclose(out[0].cpu().numpy(), ref.numpy(),
                               rtol=1e-10)


def test_device_trainer_captures_once_for_two_batches():
    _need_card()
    from muygpys_torch.optimize import make_device_trainer

    trainer = make_device_trainer(_train_model(), device="cuda")
    m1, info1 = trainer(*_train_problem(3))
    m2, info2 = trainer(*_train_problem(4), z_init=info1["z"])
    assert trainer.captures() == 1 and trainer.cache_size() == 1
    assert info1["capture_ms"] > 0 and info2["capture_ms"] == 0
    assert info1["iterations"] >= 1 and info2["iterations"] >= 1
    ref, _ = make_device_trainer(_train_model(), device="cpu")(
        *_train_problem(4), z_init=info1["z"].cpu()
    )
    from muygpys_torch.convert import arrays_from_muygps

    np.testing.assert_allclose(
        arrays_from_muygps(m2)["length_scale"],
        arrays_from_muygps(ref)["length_scale"], rtol=1e-6,
    )


def test_generic_device_chassis_on_the_card_matches_cpu():
    """Device_LBFGS_optimize (the generic objective, autograd captured in
    the step, factorizations without host reads) on the card."""
    _need_card()
    from muygpys_torch.convert import arrays_from_muygps
    from muygpys_torch.optimize import Device_LBFGS_optimize

    t, y, cw, pw = _train_problem(B=128, n=12)
    got = {}
    for dev in ("cpu", "cuda"):
        got[dev] = arrays_from_muygps(Device_LBFGS_optimize(
            _train_model(), *(torch.as_tensor(a, device=dev)
                              for a in (t, y, cw, pw))
        ))
    np.testing.assert_allclose(got["cuda"]["length_scale"],
                               got["cpu"]["length_scale"], rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fast_posterior_mean_on_the_card_matches_cpu(tmp_path, dtype):
    """The fast posterior mean's path on the card through
    examples.fast_posterior_mean: NN_Wrapper(nn_method="kernel") (K3
    pruned, counted) -> make_fast_regressor (a singular neighbourhood gives
    NaN, nothing raises) -> checkpoint -> fast_posterior_mean_serve, one
    contraction a query, against the same path on the CPU in f64 over the
    card's neighbours."""
    _need_card()
    from muygpys_torch import checkpoint
    from muygpys_torch.convert import muygps_from_arrays
    from muygpys_torch.examples.fast_posterior_mean import (
        fast_posterior_mean_serve,
        make_fast_regressor,
    )
    from muygpys_torch.neighbors import NN_Wrapper

    rng = np.random.default_rng(0)
    train = rng.uniform(size=(4096, 2))
    y = np.sin(6 * train[:, :1]) + 0.05 * rng.standard_normal((4096, 1))
    test = rng.uniform(size=(500, 2))
    model = muygps_from_arrays(length_scale=0.1, noise=1e-2, smoothness=1.5)

    nbrs = NN_Wrapper(train, 12, nn_method="kernel")
    before = _build.launches["knn_candidates_pruned"]
    coeffs, nn_fast = make_fast_regressor(
        model, nbrs, torch.as_tensor(train, dtype=dtype, device="cuda"),
        torch.as_tensor(y, dtype=dtype, device="cuda"))
    mean, closest = fast_posterior_mean_serve(model, nbrs, test, train,
                                              nn_fast, coeffs)
    assert _build.launches["knn_candidates_pruned"] >= before + 2
    nn_idx = nbrs.get_batch_nns(np.arange(4096))[0]
    exact = NN_Wrapper(train, 12, device="cpu").get_batch_nns(
        np.arange(4096))[0]
    assert (np.sort(nn_idx, 1) == np.sort(exact, 1)).all(1).mean() >= 0.98

    class CardNeighbours:
        """The card's neighbours, for the CPU reference."""

        def get_batch_nns(self, batch_indices):
            return nn_idx[batch_indices], None

        def get_nns(self, queries):
            return closest[:, None], None

    ref_c, ref_nn = make_fast_regressor(model, CardNeighbours(), train, y,
                                        device="cpu")
    ref_m, _ = fast_posterior_mean_serve(model, CardNeighbours(), test,
                                         train, ref_nn, ref_c)
    assert torch.equal(nn_fast.cpu(), ref_nn)
    assert coeffs.device.type == "cuda" and mean.shape == (500,)
    # f64: the same arithmetic in another order; f32: the posterior mean's
    # f32 floor (MEAN_TOL_F32 of chip_smoke.py) and the solve's rounding
    # times the conditioning (noise 1e-2) relative to the largest
    # coefficient
    tol = 1e-9 if dtype == torch.float64 else 5e-3
    np.testing.assert_allclose(mean.cpu().double().numpy(), ref_m.numpy(),
                               atol=tol)
    scale = float(ref_c.abs().max())
    assert float((coeffs.cpu().double() - ref_c).abs().max()) <= tol * scale
    # the fast state through a file, bit for bit, on the card
    checkpoint.save_fast_state(str(tmp_path / "f.npz"), coeffs,
                               torch.arange(3, device="cuda"))
    c2, _ = checkpoint.load_fast_state(str(tmp_path / "f.npz"))
    assert c2.device.type == "cuda" and torch.equal(c2, coeffs)
    # a singular neighbourhood: NaN there, the rest as before
    Kin = torch.eye(4, dtype=dtype, device="cuda").repeat(3, 1, 1)
    Kin[1] = -Kin[1]
    out = model.fast_coefficients(Kin, torch.ones((3, 4), dtype=dtype,
                                                  device="cuda"))
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()


def test_nn_wrapper_methods_on_the_card():
    """Every NN_Wrapper method with its index on the card: "exact" (the
    exact kernel's route at d = 2) and "brute" give the CPU's exact sets,
    "kernel" (K3 pruned, counted) >= 0.98 of them, "hnsw" recall > 0.9."""
    _need_card()
    from muygpys_torch.neighbors import NN_Wrapper

    rng = np.random.default_rng(0)
    train = rng.uniform(size=(20000, 2)).astype(np.float32)
    test = rng.uniform(size=(600, 2)).astype(np.float32)
    exact_cpu = np.sort(
        NN_Wrapper(train, 30, device="cpu").get_nns(test)[0], 1
    )
    for method in ("exact", "brute"):
        idx, d2 = NN_Wrapper(train, 30, nn_method=method).get_nns(test)
        assert idx.shape == (600, 30) and np.all(np.diff(d2, axis=1) >= 0)
        assert (np.sort(idx, 1) == exact_cpu).all(1).mean() >= 0.999
    before = _build.launches["knn_candidates_pruned"]
    idx, _ = NN_Wrapper(train, 30, nn_method="kernel").get_nns(test)
    assert _build.launches["knn_candidates_pruned"] == before + 1
    assert (np.sort(idx, 1) == exact_cpu).all(1).mean() >= 0.98
    idx, d2 = NN_Wrapper(train, 30, nn_method="hnsw",
                         random_seed=0).get_nns(test)
    assert idx.dtype == np.int64 and d2.dtype == np.float64
    recall = np.mean([len(set(a) & set(b)) / 30
                      for a, b in zip(idx, exact_cpu)])
    assert recall > 0.9, recall


@pytest.mark.parametrize(
    "n,d,k", [(1_000_000, 2, 30), (1_000_000, 2, 31), (100_000, 3, 30),
              (100_000, 4, 30)])
def test_knn_exact_kernel_matches_plain(n, d, k):
    """The exact kernel against its plain mirror on 2048 uniform queries:
    the distances are the mirror's bits (both the k smallest, ascending)
    and, at d = 2, _refine_knn's at the kernel's own indices (at d = 3 and
    4 torch.sum on a card adds the features in another order: within 2
    ulps); the sorted sets equal on >= 0.999 of queries (ties may choose
    other rows); no k-th distance above that of the tiled search's rows
    by the same expression; one launch counted."""
    _need_card()
    from muygpys_torch.gpu import knn_exact as X
    from muygpys_torch.neighbors import _brute_force_knn, _refine_knn

    rng = np.random.default_rng(n + d + k)
    train = torch.as_tensor(rng.uniform(size=(n, d)), dtype=torch.float32,
                            device="cuda")
    queries = torch.as_tensor(rng.uniform(size=(2048, d)),
                              dtype=torch.float32, device="cuda")
    index = X.build_exact_index(train)
    before = _build.launches["knn_exact_select"]
    idx, d2 = X.knn_exact_select(index, queries, k)
    torch.cuda.synchronize()
    assert _build.launches["knn_exact_select"] == before + 1
    ip, dp = X.knn_exact_select_plain(index, queries, k)
    assert torch.equal(d2, dp)
    same = (torch.sort(idx, 1).values == torch.sort(ip, 1).values).all(1)
    assert float(same.float().mean()) >= 0.999
    _, dr = _refine_knn(train, queries, idx, k)
    if d == 2:
        assert torch.equal(dr, d2)
    else:
        torch.testing.assert_close(dr, d2, rtol=2.0**-22, atol=0.0)
    cand, _ = _brute_force_knn(train, queries, k + 32)
    rows = train[_refine_knn(train, queries, cand, k)[0]]  # (Q, k, d)
    db = (queries[:, None, 0] - rows[..., 0]) ** 2
    for f in range(1, d):
        db = db + (queries[:, None, f] - rows[..., f]) ** 2
    assert bool((d2[:, -1] <= db.amax(1)).all())


def test_knn_exact_prunes_at_the_shear_shape():
    """NN_Wrapper("exact") at the shear cell's shape (1,000,000 uniform
    rows, d = 2, 2048 queries, nn = 30) takes the exact kernel, one launch
    a search, and scores under 2% of the tiles."""
    _need_card()
    from muygpys_torch.neighbors import NN_Wrapper

    rng = np.random.default_rng(11)
    train = rng.uniform(size=(1_000_000, 2)).astype(np.float32)
    nbrs = NN_Wrapper(train, 30)
    before = _build.launches["knn_exact_select"]
    idx, d2 = nbrs.get_nns(rng.uniform(size=(2048, 2)).astype(np.float32))
    assert _build.launches["knn_exact_select"] == before + 1
    assert idx.shape == (2048, 30) and np.all(np.diff(d2, axis=1) >= 0)
    stats = nbrs.stats
    assert stats["searches"] == 1 and stats["queries"] == 2048
    assert stats["tiles_total"] == 2048 * -(-1_000_000 // 256)
    share = stats["tiles_scored"] / stats["tiles_total"]
    assert 0 < share < 0.02, stats


def test_do_regress_on_the_card_matches_cpu():
    """do_regress through NN_Wrapper(nn_method="kernel") and
    Bayes_optimize on the card (f32), then the CPU's parameters served on
    the card against the CPU in f64 on the same neighbours."""
    _need_card()
    from muygpys_torch import config
    from muygpys_torch.examples.regress import do_regress, regress_any
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import AnalyticScale, Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise

    rng = np.random.default_rng(1)
    x = rng.uniform(size=(8000, 2))
    y = (np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
         + 0.1 * rng.standard_normal(8000))[:, None]
    test = rng.uniform(size=(1000, 2))

    def k_kwargs():
        return {
            "kernel": Matern(smoothness=Parameter(1.5), deformation=Isotropy(
                l2, length_scale=Parameter(0.5, (0.01, 5.0)))),
            "noise": HomoscedasticNoise(1e-3), "scale": AnalyticScale(),
        }

    kw = dict(nn_count=30, batch_count=512,
              opt_kwargs={"init_points": 3, "n_iter": 4, "random_state": 0})
    old = config.state.ftype
    try:
        config.update("ftype", 32)
        before = _build.launches["knn_candidates_pruned"]
        model, nbrs, mean, var = do_regress(
            test, x, y, nn_kwargs={"nn_method": "kernel"},
            k_kwargs=k_kwargs(), rng=np.random.default_rng(2), **kw)
        assert _build.launches["knn_candidates_pruned"] > before
        assert mean.shape == (1000, 1) and np.isfinite(mean).all()
        assert np.isfinite(var).all() and (var > 0).all()
        config.update("ftype", 64)
        ref, ref_nbrs, _, _ = do_regress(
            test, x, y, nn_kwargs={"nn_method": "kernel"},
            k_kwargs=k_kwargs(), rng=np.random.default_rng(2), device="cpu",
            **kw)
        config.update("ftype", 32)
        at_ref = MuyGPS(**k_kwargs())
        at_ref.kernel._hyperparameters["length_scale"]._set_val(
            float(ref.kernel.deformation.length_scale()))
        at_ref._make()
        at_ref.scale._set(float(ref.scale()))
        m32, v32, _ = regress_any(at_ref, test, x, nbrs, y)
        m64, v64, _ = regress_any(ref, test, x, nbrs, y, device="cpu")
    finally:
        config.update("ftype", old)
    # chip_smoke.py's serving gates: MEAN_TOL_F32 and VAR_TOL_F32 x sigma^2
    sigma2 = float(ref.scale())
    np.testing.assert_allclose(m32, m64, atol=5e-3)
    np.testing.assert_allclose(v32, v64, atol=2e-6 * sigma2)


def test_hierarchical_trainer_replays_a_second_batch_on_the_card():
    """make_device_trainer(..., batch_features=) captures once; a second
    batch with new features replays the graph and equals an eager run
    (the CPU's, f64) with those features."""
    _need_card()
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import (
        AnalyticScale,
        Parameter,
        VectorParameter,
    )
    from muygpys_torch.gp.hyperparameter.experimental import (
        HierarchicalParameter,
    )
    from muygpys_torch.gp.kernels import RBF, Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise
    from muygpys_torch.neighbors import NN_Wrapper
    from muygpys_torch.optimize import make_device_trainer

    rng = np.random.default_rng(3)
    x = rng.uniform(size=(1500, 1))
    y = np.sin(12 * x) * (x < 0.5) + np.sin(2 * x) + 0.05 * rng.standard_normal(
        (1500, 1))
    knots = np.array([[0.15], [0.35], [0.65], [0.85]])
    model = MuyGPS(
        kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=HierarchicalParameter(knots, VectorParameter(
                *[Parameter(0.3, (0.02, 1.5)) for _ in range(4)]), RBF()))),
        noise=HomoscedasticNoise(1e-4), scale=AnalyticScale(),
    )
    nbrs = NN_Wrapper(x, 20, device="cpu")
    batches = []
    for seed in (0, 1):
        bi = np.random.default_rng(seed).choice(1500, 256, replace=False)
        bni, _ = nbrs.get_batch_nns(bi)
        batches.append((bi, bni))
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)

    def run(trainer, dev, k):
        bi, bni = batches[k]
        xd, yd = xt.to(dev), yt.to(dev)
        cw, pw, bt, bnt = model.make_train_tensors(bi, bni, xd, yd)
        return trainer(bt, bnt, cw, pw, batch_features=xd[bi])

    card = make_device_trainer(model, device="cuda")
    run(card, "cuda", 0)
    m2, info2 = run(card, "cuda", 1)
    assert card.captures() == 1 and info2["capture_ms"] == 0
    ref, _ = run(make_device_trainer(model, device="cpu"), "cpu", 1)
    np.testing.assert_allclose(m2.get_opt_params()[1],
                               ref.get_opt_params()[1], rtol=1e-6)


def _deep_kernel_problem(train=3000, test=200):
    """tests/test_deep_kernel.py's field with 3,000 training points: an
    index of at least 2,048 rows runs K3p (below, the exact search)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(train + test, 6))
    y = (np.sin(2 * np.pi * X[:, 0]) + np.cos(2 * np.pi * X[:, 1]))[:, None]
    y += 0.05 * rng.standard_normal((train + test, 1))
    return (X[:train], y[:train], X[train:],
            rng.choice(train, 200, replace=False))


def _deep_kernel_model():
    from muygpys_torch.gp import MuyGPS
    from muygpys_torch.gp.deformation import Isotropy, l2
    from muygpys_torch.gp.hyperparameter import Parameter
    from muygpys_torch.gp.kernels import Matern
    from muygpys_torch.gp.noise import HomoscedasticNoise
    from muygpys_torch.nn import DeepKernelMuyGPs

    return DeepKernelMuyGPs(
        torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                            torch.nn.Linear(16, 2)),
        MuyGPS(kernel=Matern(smoothness=Parameter(1.5), deformation=Isotropy(
            l2, length_scale=Parameter(1.0))), noise=HomoscedasticNoise(1e-3)),
    )


def test_deep_kernel_training_on_the_card_matches_cpu():
    """Five f64 steps of the deep-kernel trainer on the card, rebuilding
    the index through K3p (``nn_method="pallas"``) every two, equal the
    CPU's run from the same start within 1e-8 of the largest parameter;
    the rebuilt neighbour sets are equal and K3p ran."""
    _need_card()
    from muygpys_torch import config
    from muygpys_torch.examples import deep_kernel as dk
    from muygpys_torch.neighbors import NN_Wrapper

    xtr, ytr, xte, batch = _deep_kernel_problem()
    kept = config.state.ftype
    config.update("ftype", 64)
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            model = _deep_kernel_model()
            before = _build.launches["knn_candidates_pruned"]
            nbrs, params, info = dk.train_deep_kernel_muygps(
                model, xtr, ytr, batch, NN_Wrapper(xtr, 20, device=dev),
                training_iterations=5, learning_rate=1e-2, update_frequency=2,
                nn_kwargs={"nn_method": "pallas"}, device=dev,
            )
            launched = _build.launches["knn_candidates_pruned"] - before
            out[dev] = (nbrs.get_batch_nns(batch)[0], params, info, launched)
            mean, var = dk.predict_model(model, params, xte, xtr, ytr, nbrs, 20)
            assert mean.device.type == torch.device(dev).type
            assert torch.all(torch.isfinite(mean)) and torch.all(var > 0)
    finally:
        config.update("ftype", kept)
    cpu, card = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(card[0], cpu[0])
    scale = max(float(p.abs().max()) for p in cpu[1].values())
    for name, p in cpu[1].items():
        if name == "embedding.2.bias":  # translation: rounding noise only
            continue
        np.testing.assert_allclose(card[1][name].cpu().numpy(), p.numpy(),
                                   rtol=0, atol=1e-8 * scale)
    assert card[3] > 0 and cpu[3] == 0


def test_bench_torch_prints_the_headline_line(capsys):
    """bench_torch.py's main on the card: one JSON line whose rates are
    finite and positive, with the card's name and power limit."""
    _need_card()
    import json
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import bench_torch

    out = bench_torch.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    rates = [v for k, v in out.items()
             if k == "value" or k.endswith(("_per_sec", "_per_sec_gen",
                                            "_per_sec_approx", "_per_sec_1m"))]
    assert len(rates) == 8
    assert all(np.isfinite(r) and r > 0 for r in rates)
    assert torch.cuda.get_device_name(0).split()[0] in out["device"]
