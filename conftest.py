"""Pytest settings for every test of the repository; pytest loads this file
before ``tests/conftest.py``."""

import os


def pytest_configure(config):
    # One torch intra-op thread per pytest-xdist worker: each worker's
    # OpenMP pool is as wide as the machine, so the workers together hold
    # more threads than there are cores, and the pools spin-wait at the end
    # of every parallel region.  A run without xdist keeps every core.
    if os.environ.get("PYTEST_XDIST_WORKER"):
        import torch

        torch.set_num_threads(1)
