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
    fused_predict_coords_bl,
    fused_predict_coords_bl_plain,
)

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
