"""One launch of each design of the hand-written CUDA sources, run on the
CPU one thread per CUDA thread (``_cuda_emulation``) under ThreadSanitizer,
which fails on a missing barrier; and a source with one barrier taken out,
on which it must report a race.  Skipped where ``g++`` lacks C++20
``<barrier>`` or a ThreadSanitizer runtime."""

import os

import pytest

import _cuda_emulation as emu


@pytest.mark.parametrize("launch", emu.RACE_LAUNCHES)
def test_source_has_no_race(launch):
    """One launch under ThreadSanitizer reports no data race between the
    emulated threads."""
    lib = emu.build(emu.race_source(launch), tsan=True)
    rc, races, stderr = emu.race_report(lib, launch)
    assert races == 0, stderr[-4000:]
    assert rc == 0, stderr[-4000:]


def test_knn_exact_source_has_no_race():
    """One launch under ThreadSanitizer reports no data race between the
    emulated threads."""
    lib = emu.build("knn_exact", tsan=True)
    rc, races, stderr = emu.race_report(lib, "knn-exact")
    assert races == 0, stderr[-4000:]
    assert rc == 0, stderr[-4000:]


def test_race_check_sees_a_missing_barrier():
    """K5's register design without its first ``__syncthreads`` (between
    the diagonal's stores and every thread's reads of it) reports a race."""
    with open(os.path.join(emu.CSRC, "multiout_solve.cu")) as f:
        text = f.read()
    cut = text.index("__syncthreads();", text.index("multiout_regs_kernel("))
    source = text[:cut] + text[cut + len("__syncthreads();"):]
    lib = emu.build("multiout_solve", tsan=True, source=source)
    _, races, stderr = emu.race_report(lib, "k5-registers-60")
    assert races >= 1, stderr[-4000:]
