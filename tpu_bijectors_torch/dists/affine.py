"""Affine (location-scale) transformed distributions `loc + scale * base`,
PyTorch counterpart of `tpu_bijectors/dists/affine.py` (the reference's
AffineDistribution rows `Logistic() + 2`, `Gamma(2, 3) * -3`, ...,
test/vector/univariate.jl:78-89). The support interval maps through the
affine map, its bounds flipped under a negative scale, so the registry's
interval branch picks the link. A Python-number loc and scale are static;
a tensor loc or scale over a bounded base support has no static bounds
and raises, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .base import Distribution, Support, _as_param, first_param


def _static(v):
    return float(v) if isinstance(v, (int, float)) else None


@dataclass(frozen=True)
class Affine(Distribution):
    """X = loc + scale * base, a scalar-event base, scale != 0 (it may be
    negative)."""

    base: Distribution
    loc: object = 0.0
    scale: object = 1.0

    def __post_init__(self):
        if self.base.event_ndims != 0:
            raise ValueError("Affine requires a scalar-event base distribution")
        like = first_param(self.base)
        for k in ("loc", "scale"):
            v = getattr(self, k)
            if _static(v) is None and like is not None:
                object.__setattr__(self, k, _as_param(v, like.device, like.dtype))
        if _static(self.scale) == 0.0:
            raise ValueError("Affine scale must be nonzero")

    @property
    def loc_static(self):
        return _static(self.loc)

    @property
    def scale_static(self):
        return _static(self.scale)

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def _z(self, x):
        return (x - self.loc) / self.scale

    def logpdf(self, x):
        s = self.scale
        log_s = math.log(abs(s)) if isinstance(s, float) else torch.log(torch.abs(s))
        return self.base.logpdf(self._z(x)) - log_s

    def sample(self, generator, sample_shape=()):
        return self.loc + self.scale * self.base.sample(generator, sample_shape)

    def cdf(self, x):
        F = self.base.cdf(self._z(x))
        s = self.scale_static
        if s is not None:
            return F if s > 0 else 1.0 - F
        return torch.where(self.scale > 0, F, 1.0 - F)

    def quantile(self, q):
        s = self.scale_static
        if s is not None:
            if s < 0:
                q = 1.0 - q
        else:
            q = torch.where(self.scale > 0, q, 1.0 - q)
        return self.loc + self.scale * self.base.quantile(q)

    @property
    def support(self):
        bs = self.base.support
        if bs.kind != "interval":
            raise ValueError(f"Affine of {bs.kind}-supported base unsupported")
        l, s = self.loc_static, self.scale_static
        if l is None or s is None:
            # a tensor loc or scale: only the real line keeps a static link
            if not bs.lower_finite and not bs.upper_finite:
                return bs
            raise ValueError("Affine with a tensor loc/scale over a bounded support")

        def _map(v, finite):
            if not finite:
                return math.inf if (v == math.inf) == (s > 0) else -math.inf
            return l + s * v

        lo, hi = _map(bs.lower, bs.lower_finite), _map(bs.upper, bs.upper_finite)
        lf, uf = bs.lower_finite, bs.upper_finite
        if s < 0:
            lo, hi, lf, uf = hi, lo, uf, lf
        return Support("interval", lo, hi, lf, uf)

    def to(self, device):
        mv = lambda v: v.to(device) if isinstance(v, torch.Tensor) else v  # noqa: E731
        return Affine(self.base.to(device), mv(self.loc), mv(self.scale))


def affine(base: Distribution, loc=0.0, scale=1.0) -> Distribution:
    """loc + scale * base, a nested Affine flattened into one."""
    if isinstance(base, Affine):
        return affine(base.base, loc + scale * base.loc, scale * base.scale)
    if (isinstance(loc, (int, float)) and isinstance(scale, (int, float))
            and loc == 0.0 and scale == 1.0):
        return base
    return Affine(base, loc, scale)
