"""A configuration's data, made on the device from the seed: training
points uniform on the unit square and targets from the configuration's
field plus Gaussian noise.  The same seed gives the same arrays on the
same kind of device."""

from __future__ import annotations

import math

import numpy as np


def derive(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one stream of random numbers (the
    data, the traffic, the sample that is checked) from the run's seed."""
    entropy = [seed & (2**64 - 1), stream]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, dtype=np.uint64)[0] >> 1)


def sine2d(x):
    """sin(2 pi x0) cos(2 pi x1): one output."""
    import torch

    return torch.sin(2 * math.pi * x[:, 0]) * torch.cos(2 * math.pi * x[:, 1])


def shear_demo(x):
    """The weak-lensing demo's smooth multi-mode field (convergence and the
    two shears) over sky positions: three outputs."""
    import torch

    kx = 2 * math.pi * torch.tensor([3.0, 7.0], dtype=x.dtype, device=x.device)
    ky = 2 * math.pi * torch.tensor([5.0, 2.0], dtype=x.dtype, device=x.device)
    phase = x @ torch.stack([kx, ky])  # (n, 2): the two modes
    return torch.stack([
        torch.sin(phase[:, 0]) + 0.5 * torch.cos(phase[:, 1]),
        0.5 * torch.cos(phase[:, 0]),
        0.5 * torch.sin(phase[:, 1]),
    ], dim=1)


FIELDS = {"sine2d": sine2d, "shear_demo": shear_demo}


def make(cfg: dict, seed: int, device):
    """``(points (N, d), targets (N,) or (N, outputs))``, float32 tensors on
    ``device``."""
    import torch

    g = torch.Generator(device=device).manual_seed(derive(seed, 0))
    x = torch.rand((cfg["points"], cfg["dim"]), generator=g, device=device,
                   dtype=torch.float32)
    clean = FIELDS[cfg["field"]](x)
    noise = torch.randn(clean.shape, generator=g, device=device,
                        dtype=torch.float32)
    return x, clean + cfg["field_noise"] * noise
