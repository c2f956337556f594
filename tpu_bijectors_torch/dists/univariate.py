"""Univariate families, PyTorch counterpart of
`tpu_bijectors/dists/univariate.py`: Normal and LogNormal."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..bijectors.scalar import Truncated
from .base import LeafDistribution, positive

LOG2PI = math.log(2.0 * math.pi)


def _is_log_link(b) -> bool:
    """True when the registry link is x -> log(x): the lower-only
    Truncated(0, inf) branch the positive support resolves to
    (reference truncated.jl:35)."""
    return (
        type(b) is Truncated
        and b.lower_finite
        and not b.upper_finite
        and float(b.lb) == 0.0
    )


@dataclass(frozen=True)
class Normal(LeafDistribution):
    loc: object = 0.0
    scale: object = 1.0

    _params = ("loc", "scale")

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + LOG2PI) - torch.log(self.scale)


@dataclass(frozen=True)
class LogNormal(LeafDistribution):
    mu: object = 0.0
    sigma: object = 1.0

    _params = ("mu", "sigma")

    def logpdf(self, x):
        lx = torch.log(x)
        z = (lx - self.mu) / self.sigma
        return -0.5 * (z * z + LOG2PI) - torch.log(self.sigma) - lx

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """Telescoped linked density: with the log link, logpdf(exp(v)) + v
        is the Normal density of v — finite at |v| ~ 1e10, where exp(v)
        over/underflows and the generic composition gives inf - inf."""
        if not _is_log_link(bijector):
            return None
        z = (y - self.mu) / self.sigma
        lp = -0.5 * (z * z + LOG2PI) - torch.log(self.sigma)
        return (torch.exp(y) if want_x else None), lp

    @property
    def support(self):
        return positive()
