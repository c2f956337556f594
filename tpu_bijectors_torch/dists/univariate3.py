"""Univariate families, part 3, PyTorch counterpart of
`tpu_bijectors/dists/univariate3.py`: JohnsonSU (identity link), which no
slab form serves; the traced entries of the fused evaluation do."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _random as R
from .base import LeafDistribution

LOG2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class JohnsonSU(LeafDistribution):
    """Johnson S_U(xi, lam, gamma, delta): gamma + delta asinh((x - xi) /
    lam) ~ N(0, 1)."""

    xi: object = 0.0
    lam: object = 1.0
    gamma: object = 0.0
    delta: object = 1.0

    _params = ("xi", "lam", "gamma", "delta")

    def logpdf(self, x):
        z = (x - self.xi) / self.lam
        w = self.gamma + self.delta * torch.asinh(z)
        return (torch.log(self.delta) - torch.log(self.lam)
                - 0.5 * (LOG2PI + torch.log1p(z * z)) - 0.5 * w * w)

    def cdf(self, x):
        z = (x - self.xi) / self.lam
        return torch.special.ndtr(self.gamma + self.delta * torch.asinh(z))

    def quantile(self, q):
        return self.xi + self.lam * torch.sinh((torch.special.ndtri(q) - self.gamma) / self.delta)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        z = R.normal(generator, shape, self.xi)
        return self.xi + self.lam * torch.sinh((z - self.gamma) / self.delta)
