"""The hand-written CUDA sources (K1, K1b, K2, K3 and K5), run on the CPU one
thread per CUDA thread (``_cuda_emulation``), against their plain PyTorch
versions (K4's constructor in test_torch_cuda_emulation_k4.py); and one
launch of each new design, K4's constructor included, under
ThreadSanitizer, which fails on a missing barrier.  Skipped where ``g++``
lacks C++20 ``<barrier>``."""

import math

import numpy as np
import pytest
import torch

import _cuda_emulation as emu

#: the largest row error over the row's magnitude, against the plain version
K2_LIMIT = {torch.float64: 1e-9, torch.float32: 2e-2}
#: the largest error over the output's magnitude, against the plain version
K5_LIMIT = {torch.float64: 1e-9, torch.float32: 1e-3}
#: K1 (mean, variance) absolute limits against the plain version, as on the
#: card (tests/test_torch_cuda.py: K1_TOL): f64 both orders exact to ~1e-16
#: x the conditioning at noise 1e-3; f32 the rounding of the elimination
K1_LIMIT = {torch.float64: (1e-10, 1e-10), torch.float32: (5e-3, 2e-5)}


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cuda_emulation"))
    why = emu.compiler_ready(path)
    if why:
        pytest.skip(f"the CUDA emulation needs g++ with C++20: {why}")
    return path


@pytest.fixture(scope="module")
def k2_lib(out_dir):
    import ctypes

    return ctypes.CDLL(emu.build("fused_train", out_dir))


@pytest.fixture(scope="module")
def k5_lib(out_dir):
    import ctypes

    return ctypes.CDLL(emu.build("multiout_solve", out_dir))


@pytest.fixture(scope="module")
def k3_lib(out_dir):
    import ctypes

    return ctypes.CDLL(emu.build("knn", out_dir))


@pytest.fixture(scope="module")
def k1_lib(out_dir):
    import ctypes

    return ctypes.CDLL(emu.build("fused_predict", out_dir))


@pytest.fixture(scope="module")
def tsan_dir(out_dir):
    if not emu.tsan_runtime():
        pytest.skip("g++ has no ThreadSanitizer runtime")
    for name in ("fused_train", "multiout_solve", "knn", "fused_predict",
                 "matern_nu_coeffs"):
        emu.build(name, out_dir, tsan=True)
    return out_dir


def _case_id(case):
    n, nu, power, noise_free, r, d_feat, hetero, free = case
    nu = "inf" if nu == math.inf else nu
    return (f"n{n}-{nu}-p{power}-nf{int(noise_free)}-r{r}-d{d_feat}"
            f"-h{int(hetero)}-free{int(free)}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", emu.K2_CASES, ids=_case_id)
def test_k2_source_matches_plain(k2_lib, case, dtype):
    """Every design that takes the shape (the register design to n = 32 and
    r = 4, the shared-memory design always) agrees with the plain version."""
    errors = emu.k2_errors(k2_lib, case, dtype)
    n, r = case[0], case[4]
    assert set(errors) == ({"registers", "shared"} if n <= 32 and r <= 4
                           else {"shared"})
    assert max(errors.values()) <= K2_LIMIT[dtype], errors


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("m,B", [(90, 5), (60, 6), (24, 4)])
def test_k5_source_matches_plain(k5_lib, m, B, dtype):
    """Each design that takes ``m`` agrees with the plain version on a
    batch with a singular block, and its two layouts give the same bits
    (shared memory is garbage-filled before each block, so a read of a
    value not yet written shows as a difference)."""
    from muygpys_torch.gpu.multiout_solve import (
        REGISTER_SHAPES,
        fused_multiout_solve_bl_plain,
    )

    o = 3
    front, last = emu.k5_inputs(m, B, dtype, o)
    mp, cp = fused_multiout_solve_bl_plain(
        *last[:2], torch.zeros((o, o), dtype=dtype), last[2])
    for design in ((1, 0) if (m, o) in REGISTER_SHAPES[dtype] else (0,)):
        mf, Sf = emu.k5_run(k5_lib, design, front, m, o, B, False)
        mb, Sb = emu.k5_run(k5_lib, design, last, m, o, B, True)
        assert torch.equal(mf, mb.T) and torch.equal(Sf, Sb.permute(2, 0, 1)), (
            f"design {design}: the two layouts differ")
        rel = max(float(((mb - mp).abs() / mp.abs().amax(0)).max()),
                  float(((-Sb - cp).abs() / cp.abs().amax((0, 1))).max()))
        assert rel <= K5_LIMIT[dtype], (design, rel)


@pytest.mark.parametrize("pruned", [False, True], ids=["unpruned", "pruned"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n_query", [16, 32])
def test_k3_fused_source_matches_plain(k3_lib, pruned, d, n_query):
    """The fused K3 design (the merge inside the kernel) against
    knn_select_plain on 2048 train points at 256 bins, k = 38: distances
    bit-equal (both are in ascending key order), index sets equal; the kept
    design's key state bit-equal to its mirror on the same launch inputs."""
    from muygpys_torch.gpu import knn as K

    prep = emu.k3_problem(n_train=2048, n_query=n_query, d=d, pruned=pruned)
    if pruned and d == 2:
        run = prep.lb <= prep.ub[:, None]
        assert 0 < int(run.sum()) < run.numel(), "no tile was skipped"
    idx, d2 = emu.k3_select(k3_lib, prep, 38)
    ip, dp = K.knn_select_plain(prep, 38)
    assert torch.equal(d2, dp)
    assert torch.equal(torch.sort(idx, 1).values, torch.sort(ip, 1).values)
    s1, s2 = emu.k3_keys(k3_lib, prep)
    p1, p2 = K.knn_candidates_plain(
        prep.q, prep.qsq, prep.tT, prep.tsq, prep.bins, prep.train_tile,
        prep.query_tile, prep.chunk_mask, prep.lb, prep.ub)
    assert torch.equal(s1, p1) and torch.equal(s2, p2)


def test_k3_fused_source_small_train_and_ties(k3_lib):
    """Fewer train points than 2 * bins: sentinel and padded-column keys
    (all equal) survive into the k selected; they come back as +inf at an
    in-range index, as from _merge_decode, and the ties do not disturb the
    distances."""
    from muygpys_torch.gpu import knn as K

    rng = np.random.default_rng(3)
    train = torch.as_tensor(rng.uniform(size=(300, 2)).astype(np.float32))
    queries = torch.as_tensor(rng.uniform(size=(8, 2)).astype(np.float32))
    prep = K.prepare(train, queries, 64, query_tile=8, train_tile=256,
                     bins=256)
    idx, d2 = emu.k3_select(k3_lib, prep, 64)
    ip, dp = K.knn_select_plain(prep, 64)
    assert torch.equal(d2, dp)
    assert int(idx.max()) < 300 and int(idx.min()) >= 0
    assert not torch.isinf(d2).any()
    prep = K.prepare(train[:40], queries, 64, query_tile=8, train_tile=256,
                     bins=256)
    idx, d2 = emu.k3_select(k3_lib, prep, 64)
    ip, dp = K.knn_select_plain(prep, 64)
    assert torch.equal(d2, dp) and torch.isinf(d2).any()
    assert int(idx.max()) < 40


#: K1 cases: (n, smoothness, metric_power, r, heteroscedastic)
K1_CASES = [
    (30, 0.5, 1, 1, False),
    (30, 1.5, 1, 1, False),
    (30, 1.5, 1, 2, True),
    (30, math.inf, 1, 2, False),
    (30, "rbf", 2, 1, False),
    (30, "rbf", 2, 2, True),
    (30, "gen", 1, 1, False),
    (30, "gen", 1, 2, True),
    (32, 1.5, 1, 1, False),
    (8, 1.5, 1, 3, True),
    (33, 1.5, 1, 1, False),
]


def _k1_id(case):
    n, nu, power, r, hetero = case
    nu = "inf" if nu == math.inf else nu
    return f"n{n}-{nu}-p{power}-r{r}-h{int(hetero)}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", K1_CASES, ids=_k1_id)
def test_k1_source_matches_plain(k1_lib, case, dtype):
    """Every K1 design that takes the shape (registers to n = 32 and r = 4,
    shared memory always) against fused_predict_coords_bl_plain."""
    from muygpys_torch.gpu.fused_predict import (
        fused_predict_coords_bl_plain,
        k1_design,
    )

    n, nu, power, r, hetero = case
    ins = emu.k1_inputs(n, 2, r, 11, dtype, hetero=hetero, nu=nu)
    mp, vp = fused_predict_coords_bl_plain(*ins, smoothness=nu,
                                           metric_power=power)
    designs = (1, 0) if k1_design(n, r, dtype, nu) == "registers" else (0,)
    assert len(designs) == (2 if n <= 32 else 1)
    tol_m, tol_v = K1_LIMIT[dtype]
    for design in designs:
        m, v = emu.k1_run(k1_lib, design, *ins, nu, power)
        assert torch.isfinite(m).all() and torch.isfinite(v).all()
        assert float((m - mp).abs().max()) <= tol_m, design
        assert float((v - vp).abs().max()) <= tol_v, design


#: K1b cases: every closed form, RBF on F2 and "gen", at n = 1, 8 and 30
K1B_SMOOTHNESS = [(0.5, 1), (1.5, 1), (2.5, 1), (math.inf, 1), ("rbf", 2),
                  ("gen", 1)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("n", [1, 8, 30])
@pytest.mark.parametrize("nu,power", K1B_SMOOTHNESS,
                         ids=[f"{nu}-p{p}" for nu, p in K1B_SMOOTHNESS])
def test_k1b_source_matches_plain(k1_lib, nu, power, n, r, dtype):
    """Both K1b designs (registers, the launcher's pick at these shapes,
    and the kept shared-memory design) against fused_predict_bl_plain."""
    from muygpys_torch.gpu.fused_predict import fused_predict_bl_plain, k1_design

    assert k1_design(n, r, dtype, nu) == "registers"
    ins = emu.k1b_inputs(n, r, 11, dtype, nu=nu, power=power, seed=n + r)
    mp, vp = fused_predict_bl_plain(*ins, smoothness=nu, metric_power=power)
    tol_m, tol_v = K1_LIMIT[dtype]
    for design in (1, 0):
        m, v = emu.k1b_run(k1_lib, design, *ins, nu, power)
        assert torch.isfinite(m).all() and torch.isfinite(v).all()
        assert float((m - mp).abs().max()) <= tol_m, design
        assert float((v - vp).abs().max()) <= tol_v, design


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nu", [1.5, "gen"])
def test_k1b_source_reads_both_triangles(k1_lib, nu, dtype):
    """On a pw whose two triangles differ, both designs give the plain
    version's result (which reads the pivot row from the upper triangle and
    the column below it from the lower), not the mirrored one's."""
    from muygpys_torch.gpu.fused_predict import fused_predict_bl_plain

    ins = emu.k1b_inputs(30, 2, 11, dtype, nu=nu, symmetric=False, noise=0.1)
    pw = ins[0]
    mp, vp = fused_predict_bl_plain(*ins, smoothness=nu)
    # the lower triangle mirrored: the symmetric distances before the upper
    # triangle was scaled
    lower = torch.tril(pw.permute(2, 0, 1)).permute(1, 2, 0)
    mirrored = lower + torch.tril(pw.permute(2, 0, 1), -1).permute(2, 1, 0)
    ms, vs = fused_predict_bl_plain(mirrored, *ins[1:], smoothness=nu)
    tol_m, tol_v = K1_LIMIT[dtype]
    assert float((ms - mp).abs().max()) > 4 * tol_m
    for design in (1, 0):
        m, v = emu.k1b_run(k1_lib, design, *ins, nu, 1)
        assert float((m - mp).abs().max()) <= tol_m, design
        assert float((v - vp).abs().max()) <= tol_v, design


@pytest.mark.parametrize("launch", emu.RACE_LAUNCHES)
def test_source_has_no_race(tsan_dir, launch):
    """One launch under ThreadSanitizer reports no data race between the
    emulated threads."""
    rc, races, stderr = emu.race_report(tsan_dir, launch)
    assert races == 0, stderr[-4000:]
    assert rc == 0, stderr[-4000:]
