"""muygpys_torch package rules: imports, configuration, device selection,
and the kernel build machinery as far as it runs without a card."""

import ast
import ctypes
import os
import pathlib

import pytest
import torch

from muygpys_torch import config
from muygpys_torch.gpu import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_files():
    return sorted((ROOT / "muygpys_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py"
    ]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_port_imports_no_jax(path):
    """The port, its smoke script and its headline benchmark import
    neither JAX (nor flax or optax) nor the JAX package, at top level or
    inside functions."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax",
                                "muygpys_tpu"), (
                f"{path.name} imports {name}"
            )


def test_ftype_and_update():
    # the test bootstrap runs with MUYGPYS_FTYPE=64
    assert config.state.ftype == int(os.environ.get("MUYGPYS_FTYPE", "32"))
    old = config.state.ftype
    try:
        config.update("ftype", 32)
        assert config.ftype() == torch.float32
        config.update("muygpys_ftype", "64")
        assert config.ftype() == torch.float64
        with pytest.raises(ValueError, match="32 or 64"):
            config.update("ftype", 16)
        with pytest.raises(ValueError, match="unknown config key"):
            config.update("dtype", 32)
    finally:
        config.update("ftype", old)


def test_env_ftype_validation(monkeypatch):
    monkeypatch.setenv("MUYGPYS_FTYPE", "16")
    with pytest.raises(ValueError, match="MUYGPYS_FTYPE"):
        config._env_ftype()


def test_full_precision_products():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_device_selection(monkeypatch):
    assert config.device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.device() == torch.device("cuda")


def test_library_name_tracks_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build.library_path("k")
    src.write_text("// two")
    second = _build.library_path("k")
    assert first != second and first.parent == _build.BUILD_DIR
    assert first.name.startswith("libk_") and first.suffix == ".so"


def test_library_name_tracks_headers(tmp_path, monkeypatch):
    """A header under csrc/ that a source includes, directly or through
    another header, is part of the library's digest; one it does not include
    is not."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one")
    (tmp_path / "other.cuh").write_text("// one")
    assert [p.name for p in sorted(_build.source_files("k"))] == [
        "a.cuh", "b.cuh", "k.cu"
    ]
    first = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// two")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// two")
    assert _build.library_path("k") != first
    # the shipped sources: both fused kernels include K4's header
    monkeypatch.undo()
    for name in ("fused_predict", "fused_train"):
        assert _build.CSRC / "matern_nu.cuh" in _build.source_files(name)
    assert _build.source_files("knn") == [_build.CSRC / "knn.cu"]
    assert _build.source_files("multiout_solve") == [
        _build.CSRC / "multiout_solve.cu"
    ]
    assert str(_build.CSRC) in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "absent"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["knn"])


def test_sources_are_present():
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "muygpys_cuda_error_string" in text
        assert "cudaGetLastError" in text
        assert "muygpys_tpu/pallas/" in text  # names the kernel it replaces


def test_launch_counters_reset():
    """One count per kernel, one per design of K1, K1b, K2, K3 and K5, and
    one of K1's general-order launches; ``count`` adds one to each name it
    is given, and a reset zeroes them all."""
    before = _build.launches["knn_candidates"]
    _build.count("knn_candidates", "knn_candidates")
    assert _build.launches["knn_candidates"] == before + 2
    _build.reset_launches()
    assert set(_build.launches) == {
        "fused_predict_coords", "fused_predict_coords/registers",
        "fused_predict_coords/shared", "fused_predict_coords/gen",
        "fused_predict",
        "fused_predict/registers", "fused_predict/shared", "knn_candidates",
        "knn_candidates_pruned", "knn_candidates/fused", "knn_candidates/keys",
        "fused_train_stats",
        "fused_train_stats/registers", "fused_train_stats/shared",
        "multiout_solve", "multiout_solve/registers", "multiout_solve/shared",
        "matern_nu_coeffs", "knn_exact_select", "knn_query_order",
        "knn_query_order/torch",
    }
    assert all(v == 0 for v in _build.launches.values())


def test_check_passes_success_code():
    _build.check(0, "knn", "knn_candidates")  # no library needed for 0
    assert _build.ptr(None).value is None
    assert isinstance(_build.ptr(torch.zeros(2)), ctypes.c_void_p)


def test_every_kernel_source_is_built_and_counted():
    """One library per hand-written source, one launch counter per
    ``__global__`` entry a wrapper launches."""
    assert _build.SOURCES == (
        "fused_predict", "knn", "fused_train", "multiout_solve",
        "matern_nu_coeffs", "knn_exact",
    )
    on_disk = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert on_disk == sorted(_build.SOURCES)
    text = (_build.CSRC / "multiout_solve.cu").read_text()
    assert "__global__" in text and "pivot_floor" in text
    for symbol in ("multiout_solve_f32", "multiout_solve_f64"):
        assert f"int {symbol}(" in text
    # no library stands in for the elimination
    for library in ("cusolver", "cublas", "cutlass"):
        assert library not in text.lower()
    # K4's constructor: one kernel in both dtypes, built without contraction
    text = (_build.CSRC / "matern_nu_coeffs.cu").read_text()
    assert "__global__" in text
    for symbol in ("matern_nu_coeffs_f32", "matern_nu_coeffs_f64"):
        assert f"int {symbol}(" in text
    assert "-fmad=false" in _build.EXTRA_FLAGS["matern_nu_coeffs"]


@pytest.mark.parametrize(
    "module",
    ["ops.shear", "gp.noise.shear", "gp.kernels.experimental",
     "gp.kernels.experimental.shear", "gpu.multiout_solve",
     "optimize.shear_objective"],
)
def test_shear_modules_import_without_jax(module):
    """The shear slice's modules import in a fresh interpreter that has
    neither jax nor the JAX package loaded afterwards."""
    import subprocess
    import sys

    code = (
        f"import sys, muygpys_torch.{module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'muygpys_tpu')]\n"
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )


@pytest.mark.parametrize(
    "module",
    ["checkpoint", "convert", "gp.multivariate_muygps", "gp.fast_mean",
     "gp.fast_precompute", "ops.noise", "gp.noise.null",
     "gp.deformation.null", "gp.hyperparameter.tensor",
     "gp.hyperparameter.vector", "examples.fast_posterior_mean"],
)
def test_fast_mean_slice_modules_import_without_jax(module):
    """The fast-mean, multivariate and checkpoint modules import in a fresh
    interpreter that has neither jax nor the JAX package loaded
    afterwards (the checkpoint format is the JAX package's, but the code
    is the port's own copy)."""
    import subprocess
    import sys

    code = (
        f"import sys, muygpys_torch.{module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'muygpys_tpu')]\n"
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )


@pytest.mark.parametrize(
    "module",
    ["neighbors", "native", "native.hnsw", "optimize.bayes",
     "optimize.experimental", "optimize.experimental.chassis",
     "gp.hyperparameter.experimental",
     "gp.hyperparameter.experimental.hierarchical", "examples",
     "examples.from_indices", "examples.regress", "examples.classify",
     "examples.two_class_classify_uq"],
)
def test_workflow_slice_modules_import_without_jax(module):
    """The host KNN methods, HNSW, Bayes, hierarchical length scales, the
    mini-batch chassis and the example workflows import in a fresh
    interpreter that has neither jax nor the JAX package loaded afterwards
    (hnsw.cpp and bayes.py are the port's own copies)."""
    import subprocess
    import sys

    code = (
        f"import sys, muygpys_torch.{module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'muygpys_tpu')]\n"
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )


@pytest.mark.parametrize(
    "module",
    ["muygpys_torch.nn", "muygpys_torch.nn.muygps_layer",
     "muygpys_torch.examples.deep_kernel", "muygpys_torch.performance",
     "muygpys_torch.performance.headline",
     "muygpys_torch.performance.benchmark", "muygpys_torch._test",
     "muygpys_torch._test.datasets", "muygpys_torch._test.oracle",
     "muygpys_torch._test.sampler", "muygpys_torch._test.real_data",
     "muygpys_torch.examples.fast_posterior_mean", "bench_torch"],
)
def test_deep_kernel_slice_modules_import_without_jax(module):
    """The deep-kernel layer and trainer, the headline harness, the test
    helpers and bench_torch.py import in a fresh interpreter that has
    neither jax, flax, optax nor the JAX package loaded afterwards."""
    import subprocess
    import sys

    code = (
        f"import sys, {module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'muygpys_tpu')]\n"
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )


@pytest.mark.parametrize(
    "module",
    ["muygpys_torch.parallel", "muygpys_torch.parallel.comm",
     "muygpys_torch.parallel.mesh", "muygpys_torch.parallel.sharding",
     "muygpys_torch.parallel.knn", "muygpys_torch.performance.scaling",
     "_torch_parallel_worker", "_torch_mp_worker"],
)
def test_sharded_slice_modules_import_without_jax(module):
    """The sharded paths, the scaling harness and the rank workers the
    tests spawn import in a fresh interpreter that has neither jax nor the
    JAX package loaded afterwards (a rank imports torch, numpy and the port
    only)."""
    import subprocess
    import sys

    code = (
        f"import sys, {module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'muygpys_tpu')]\n"
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=str(ROOT),
        env={**os.environ,
             "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])},
    )
