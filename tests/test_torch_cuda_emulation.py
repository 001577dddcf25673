"""The hand-written K2 and K5 CUDA sources, run on the CPU one thread per
CUDA thread (``_cuda_emulation``), against their plain PyTorch versions;
and one launch of each design under ThreadSanitizer, which fails on a
missing barrier.  Skipped where ``g++`` lacks C++20 ``<barrier>``."""

import math

import pytest
import torch

import _cuda_emulation as emu

#: the largest row error over the row's magnitude, against the plain version
K2_LIMIT = {torch.float64: 1e-9, torch.float32: 2e-2}
#: the largest error over the output's magnitude, against the plain version
K5_LIMIT = {torch.float64: 1e-9, torch.float32: 1e-3}


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
def tsan_dir(out_dir):
    if not emu.tsan_runtime():
        pytest.skip("g++ has no ThreadSanitizer runtime")
    for name in ("fused_train", "multiout_solve"):
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


@pytest.mark.parametrize("launch", emu.RACE_LAUNCHES)
def test_source_has_no_race(tsan_dir, launch):
    """One launch under ThreadSanitizer reports no data race between the
    emulated threads."""
    rc, races, stderr = emu.race_report(tsan_dir, launch)
    assert races == 0, stderr[-4000:]
    assert rc == 0, stderr[-4000:]
