"""muygpys_torch._test against muygpys_tpu._test: the port's copies of the
numpy/scipy test helpers give equal arrays for one seed (datasets, the
numpy oracle, the dense-GP samplers), and the real-data loaders behave
alike with the data present (a pickle written here) and absent."""

import os
import pickle

import numpy as np
import pytest

from muygpys_tpu._test import datasets as jdata
from muygpys_tpu._test import oracle as jora
from muygpys_tpu._test import real_data as jreal
from muygpys_tpu._test import sampler as jsamp
from muygpys_torch._test import datasets as tdata
from muygpys_torch._test import oracle as tora
from muygpys_torch._test import real_data as treal
from muygpys_torch._test import sampler as tsamp


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn,kw", [
    ("heaton_style", dict(train_count=300, test_count=50)),
    ("stargal_style", dict(train_count=200, test_count=40, embed_dim=6)),
])
@pytest.mark.parametrize("seeded", [False, True])
def test_datasets_equal_jax(fn, kw, seeded):
    if seeded:
        kw = dict(kw, rng=np.random.default_rng(5))
        _equal(getattr(tdata, fn)(**dict(kw, rng=np.random.default_rng(5))),
               getattr(jdata, fn)(**kw))
    else:
        _equal(getattr(tdata, fn)(**kw), getattr(jdata, fn)(**kw))


@pytest.fixture(scope="module")
def oracle_inputs():
    rng = np.random.default_rng(2)
    data = rng.uniform(size=(40, 3))
    nn = rng.integers(0, 40, size=(10, 6))
    idx = np.arange(10)
    A = rng.standard_normal((10, 6, 6))
    Kin = A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6)
    Kcross = rng.uniform(size=(10, 6))
    y = rng.standard_normal((10, 6))
    return data, nn, idx, Kin, Kcross, y


@pytest.mark.parametrize("name", [
    "crosswise_diffs", "pairwise_diffs", "crosswise_l2", "pairwise_l2",
    "matern", "rbf", "posterior_mean", "diagonal_variance",
    "analytic_scale", "dense_gp_sample",
])
def test_oracle_equals_jax(oracle_inputs, name):
    data, nn, idx, Kin, Kcross, y = oracle_inputs
    d = jora.pairwise_l2(data, nn)
    args = {
        "crosswise_diffs": lambda: (data, data, idx, nn),
        "pairwise_diffs": lambda: (data, nn),
        "crosswise_l2": lambda: (data, data, idx, nn),
        "pairwise_l2": lambda: (data, nn),
        "matern": lambda: (d, 1.2),
        "rbf": lambda: (d**2,),
        "posterior_mean": lambda: (Kin, Kcross, y),
        "diagonal_variance": lambda: (Kin, Kcross),
        "analytic_scale": lambda: (Kin, y),
    }
    if name == "dense_gp_sample":
        t = tora.dense_gp_sample(np.random.default_rng(4), data, 1.5, 0.3,
                                 1e-4, n_draws=2)
        j = jora.dense_gp_sample(np.random.default_rng(4), data, 1.5, 0.3,
                                 1e-4, n_draws=2)
    else:
        t = getattr(tora, name)(*args[name]())
        j = getattr(jora, name)(*args[name]())
    _equal(t, j)
    if name == "matern":  # the closed branch at nu = inf too
        _equal(tora.matern(d, np.inf), jora.matern(d, np.inf))


@pytest.mark.parametrize("cls,kw", [
    ("UnivariateSampler", dict(data_count=120, train_ratio=0.2)),
    ("UnivariateSampler2D", dict(points_per_dim=9, train_ratio=0.3)),
])
def test_samplers_equal_jax(cls, kw):
    t = getattr(tsamp, cls)(rng=np.random.default_rng(8), **kw)
    j = getattr(jsamp, cls)(rng=np.random.default_rng(8), **kw)
    _equal(t.features(), j.features())
    _equal(t.sample(), j.sample())
    _equal(t.train_mask, j.train_mask)


def test_real_data_absent_raises_in_both(tmp_path, monkeypatch):
    """With no data present each loader raises FileNotFoundError naming
    the path it looked at; the port looks inside its checkout by default."""
    monkeypatch.setenv("MUYGPYS_DATA_DIR", str(tmp_path / "none"))
    for mod in (treal, jreal):
        with pytest.raises(FileNotFoundError, match="none"):
            mod.load_heaton()
        with pytest.raises(FileNotFoundError, match="embedded_40_galstar"):
            mod.load_stargal_embedded()
    monkeypatch.delenv("MUYGPYS_DATA_DIR")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert treal.data_dir() == os.path.join(root, "data")


def test_real_data_loaders_equal_jax(tmp_path, monkeypatch):
    """Pickles in the reference's schema, written here, load to equal
    arrays through both packages' loaders."""
    rng = np.random.default_rng(9)
    (tmp_path / "heaton").mkdir()
    (tmp_path / "star-gal").mkdir()
    heaton = tuple({"input": rng.uniform(size=(n, 2)),
                    "output": rng.normal(size=(n, 1))} for n in (30, 10))
    stargal = tuple({"input": rng.normal(size=(n, 8)),
                     "output": np.eye(2)[rng.integers(0, 2, n)]}
                    for n in (20, 5))
    with open(tmp_path / "heaton" / "sub_heaton.pkl", "wb") as f:
        pickle.dump(heaton, f)
    with open(tmp_path / "star-gal" / "embedded_8_galstar.pkl", "wb") as f:
        pickle.dump(stargal, f)
    monkeypatch.setenv("MUYGPYS_DATA_DIR", str(tmp_path))
    t, j = treal.load_heaton(), jreal.load_heaton()
    _equal(t, j)
    assert t[1].shape == (30,) and t[0].dtype == np.float64
    _equal(treal.load_stargal_embedded(8), jreal.load_stargal_embedded(8))


def test_real_heaton_when_present():
    """The real Heaton data, where someone has placed it: both loaders give
    the same arrays.  Skips, saying so, when it is absent (it is not
    shipped and nothing fetches it)."""
    try:
        t = treal.load_heaton()
    except FileNotFoundError as err:
        pytest.skip(f"real data absent: {err}")
    _equal(t, tuple(np.asarray(a) for a in t))
    assert t[0].shape[1] == 2
