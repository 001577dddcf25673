"""muygpys_torch.native (the port's HNSW index) against muygpys_tpu.native."""

import numpy as np
import pytest

from muygpys_torch.native import HNSW
from muygpys_torch.native import hnsw as port_hnsw
from muygpys_torch.neighbors import NN_Wrapper
from muygpys_tpu.native import HNSW as JaxHNSW
from muygpys_tpu.neighbors import NN_Wrapper as JaxNN


@pytest.fixture(scope="module")
def data(rng):
    train = rng.normal(size=(2000, 10))
    test = rng.normal(size=(311, 10))
    return train, test


def _code_lines(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.lstrip().startswith("//")]


def test_source_is_the_jax_packages_code_built_the_same_way():
    """The port's copy of hnsw.cpp is JAX's code line for line (comments
    aside), compiled with the same g++ flags, into build/muygpys_torch/
    and never into either package's directory."""
    import pathlib

    import muygpys_tpu.native.hnsw as jax_hnsw

    jax_src = pathlib.Path(jax_hnsw._SRC)
    assert _code_lines(port_hnsw.SRC) == _code_lines(jax_src)
    jax_cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-march=native", "-pthread"]
    assert ["g++", *port_hnsw.GXX_FLAGS] == jax_cmd
    so = port_hnsw.build()
    assert so.exists() and so.parent == port_hnsw.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "muygpys_torch")
    assert so.parent != port_hnsw.SRC.parent


@pytest.mark.parametrize("seed", [0, 7])
def test_index_matches_jax_bit_for_bit(data, seed):
    train, test = data
    port = HNSW(train.shape[1], len(train), random_seed=seed)
    ref = JaxHNSW(train.shape[1], len(train), random_seed=seed)
    port.add_items(train)
    ref.add_items(train)
    assert len(port) == len(ref) == len(train)
    i_t, d_t = port.knn_query(test, k=10)
    i_j, d_j = ref.knn_query(test, k=10)
    assert i_t.dtype == np.int64 and d_t.dtype == np.float32
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(d_t, d_j)


def test_nn_wrapper_hnsw_matches_jax_and_recalls(data):
    """NN_Wrapper(nn_method="hnsw") equals JAX's index for index (int64
    indices, float64 squared distances) with recall > 0.9 against the exact
    sets (tests/test_neighbors.py's gate)."""
    train, test = data
    nn = 10
    approx = NN_Wrapper(train, nn, nn_method="hnsw", random_seed=7,
                        device="cpu")
    assert approx.nbrs._lib is not None
    ai, ad = approx.get_nns(test)
    ji, jd = JaxNN(train, nn, nn_method="hnsw", random_seed=7).get_nns(test)
    np.testing.assert_array_equal(ai, ji)
    np.testing.assert_array_equal(ad, jd)
    assert ai.dtype == np.int64 and ad.dtype == np.float64
    ei, ed = NN_Wrapper(train, nn, device="cpu").get_nns(test)
    recall = np.mean(
        [len(set(ai[i]) & set(ei[i])) / nn for i in range(len(test))]
    )
    assert recall > 0.9, f"recall={recall}"
    assert np.all(np.diff(ad, axis=1) >= -1e-5)
    np.testing.assert_allclose(ad[:, 0], ed[:, 0], rtol=1e-4, atol=1e-5)


def test_hnsw_batch_nns_drop_self(data):
    train, _ = data
    approx = NN_Wrapper(train, 8, nn_method="hnsw", random_seed=7,
                        device="cpu")
    batch = np.arange(50)
    idx, d2 = approx.get_batch_nns(batch)
    assert idx.shape == (50, 8) and d2.shape == (50, 8)
    assert not np.any(idx == batch[:, None])
    j_idx, _ = JaxNN(train, 8, nn_method="hnsw",
                     random_seed=7).get_batch_nns(batch)
    np.testing.assert_array_equal(idx, j_idx)


def test_max_elements_defaults_to_the_train_count(data, monkeypatch):
    train, _ = data
    seen = {}
    real = port_hnsw.HNSW.__init__

    def spy(self, dim, **kwargs):
        seen.update(kwargs)
        real(self, dim, **kwargs)

    monkeypatch.setattr(port_hnsw.HNSW, "__init__", spy)
    NN_Wrapper(train[:300], 5, nn_method="hnsw", ef_construction=100, M=8,
               leaf_size=3, device="cpu")
    assert seen == {"max_elements": 300, "ef_construction": 100, "M": 8}


def test_failed_build_names_the_compiler_output(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's message; nothing is
    left where the library would be."""
    bad = tmp_path / "hnsw.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_hnsw, "SRC", bad)
    monkeypatch.setattr(port_hnsw, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on hnsw.cpp"):
        port_hnsw.build()
    assert not port_hnsw.library_path().exists()


def test_edited_source_gets_a_new_library(tmp_path, monkeypatch):
    src = tmp_path / "hnsw.cpp"
    src.write_bytes(port_hnsw.SRC.read_bytes())
    monkeypatch.setattr(port_hnsw, "SRC", src)
    first = port_hnsw.library_path()
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert port_hnsw.library_path() != first


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Builds started together wait on the build directory's file lock:
    one compiles, the others find its library (the compiler is a stand-in
    that takes a moment and writes the output file)."""
    import threading
    import time

    compiles = []

    def fake_run(cmd, **kwargs):
        compiles.append(cmd)
        time.sleep(0.3)
        with open(cmd[cmd.index("-o") + 1], "wb") as out:
            out.write(b"library")
        return type("Done", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()

    monkeypatch.setattr(port_hnsw, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_hnsw.subprocess, "run", fake_run)
    built = []
    threads = [threading.Thread(target=lambda: built.append(port_hnsw.build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiles) == 1
    assert built == [port_hnsw.library_path()] * 4
    assert port_hnsw.library_path().read_bytes() == b"library"
