"""The port's scaling harness (muygpys_torch.performance.scaling) on gloo
ranks on the CPU: the mechanics of tests/test_distributed.py's
TestScalingHarness (one world per rank count; a world of one issues no
collective; two ranks move a small, non-zero number of bytes), the byte
account against a hand count of each program's collectives, and
``collective_bytes`` itself.  Ranks sharing CPU cores measure mechanics,
not efficiency."""

import numpy as np
import pytest
import torch

from muygpys_torch.parallel import comm
from muygpys_torch.performance.scaling import (
    collective_bytes,
    measure_scaling,
    measure_serve_scaling,
)

F64 = 8


def test_collective_bytes_counts_each_kind():
    """An all-reduce counts its tensor, an all-gather its gathered output
    (the JAX harness counts an HLO module's result shapes); a call that
    issues no collective gives {}."""
    def step():
        comm._count("all-reduce", torch.zeros((), dtype=torch.float32))
        comm._count("all-gather", torch.zeros((16, 8), dtype=torch.float64))
        comm._count("all-reduce", torch.zeros(3, dtype=torch.float64))

    assert collective_bytes(step) == {
        "all-reduce": 4 + 3 * F64, "all-gather": 16 * 8 * F64,
    }
    assert collective_bytes(lambda: None) == {}


def _hand_count(program):
    """All-reduce bytes of one step at two ranks in f64, two free
    parameters (length scale, noise)."""
    if program == "xla_train":
        # forward: sigma^2's numerator and row count, the loss's sum;
        # backward: the numerator and the loss again, and each parameter's
        # gradient mean
        return {"all-reduce": (3 + 2 + 2) * F64}
    # K2's epilogue: [sum q, sum dq/dls, row count], then [value, two
    # gradient terms]
    return {"all-reduce": (3 + 3) * F64}


@pytest.mark.parametrize("program", ["xla_train", "fused_train"])
def test_weak_scaling_mechanics(program):
    records = measure_scaling(
        device_counts=[1, 2], batch_per_device=64, nn=8, steps=2, warmup=1,
        program=program, device="cpu",
    )
    assert [r["devices"] for r in records] == [1, 2]
    assert [r["batch"] for r in records] == [64, 128]
    assert records[0]["collective_bytes_per_step"] == {}
    comm_bytes = records[1]["collective_bytes_per_step"]
    assert 0 < sum(comm_bytes.values()) <= 4096, comm_bytes
    assert comm_bytes == _hand_count(program)
    assert records[0]["efficiency"] == 1.0
    assert all(np.isfinite(r["rows_per_sec"]) and r["step_seconds"] > 0
               for r in records)


@pytest.mark.slow
def test_serve_shard_train_scaling_mechanics():
    """The train-sharded serving chain: the candidate rows' all-gather
    (2 shards x 1024-query bucket x (8 + 8) candidates x 3 columns) and the
    outputs' (mean and variance of 1024 queries), in the server's float
    type."""
    from muygpys_torch import config

    size = torch.finfo(config.ftype()).bits // 8
    records = measure_serve_scaling(
        device_counts=[2], bucket_per_device=512, train_per_device=1024,
        nn=8, steps=1, warmup=1, device="cpu",
    )
    comm_bytes = records[0]["collective_bytes_per_step"]
    assert comm_bytes == {
        "all-gather": (2 * 1024 * 16 * 3 + 2 * 1024) * size
    }
    assert np.isfinite(records[0]["preds_per_sec"])
