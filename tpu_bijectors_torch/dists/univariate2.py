"""Univariate families, part 2, PyTorch counterpart of
`tpu_bijectors/dists/univariate2.py`: BetaPrime and InverseGaussian (log
link) and TriangularDist (logit link), which no slab form serves; the
traced entries of the fused evaluation (`vectorize/fused_traced.py`) do.

BetaPrime and InverseGaussian have telescoped `fused_linked_logdensity`
hooks, as the port's other log-link families do: written in v = log x,
their linked densities are finite or -inf at |v| ~ 1e10, where the
generic composition forms inf - inf or inf / inf (the JAX package has no
such hook for these two; ROADMAP's differences from the reference).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils import log1pexp
from . import _random as R
from ._special import betainc
from .base import LeafDistribution, interval, positive
from .univariate import _is_log_link, _static_bound

LOG2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class BetaPrime(LeafDistribution):
    a: object = 1.0
    b: object = 1.0

    _params = ("a", "b")
    _cdf_fd = ("a", "b")  # betainc has no derivative in a or b

    def _lbeta(self):
        return torch.lgamma(self.a) + torch.lgamma(self.b) - torch.lgamma(self.a + self.b)

    def logpdf(self, x):
        a, b = self.a, self.b
        return (a - 1.0) * torch.log(x) - (a + b) * torch.log1p(x) - self._lbeta()

    def cdf(self, x):
        xc = torch.clamp_min(x, 0.0)
        return betainc(self.a, self.b, xc / (1.0 + xc))

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """With the log link, log x = v and log1p(x) = softplus(v):
        a v - (a + b) softplus(v) - log B(a, b)."""
        if not _is_log_link(bijector):
            return None
        lp = self.a * y - (self.a + self.b) * log1pexp(y) - self._lbeta()
        return (torch.exp(y) if want_x else None), lp

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = R.beta(generator, self.a, self.b, shape)
        return u / (1.0 - u)


@dataclass(frozen=True)
class InverseGaussian(LeafDistribution):
    """Wald distribution IG(mu, lambda)."""

    mu: object = 1.0
    lam: object = 1.0

    _params = ("mu", "lam")

    def logpdf(self, x):
        mu, lam = self.mu, self.lam
        return 0.5 * (torch.log(lam) - LOG2PI - 3.0 * torch.log(x)) - lam * (
            x - mu
        ) ** 2 / (2.0 * mu * mu * x)

    def cdf(self, x):
        mu, lam = self.mu, self.lam
        xs = torch.clamp_min(x, torch.finfo(x.dtype).tiny)
        rt = torch.sqrt(lam / xs)
        ndtr = torch.special.ndtr
        val = ndtr(rt * (xs / mu - 1.0)) + torch.exp(2.0 * lam / mu) * ndtr(-rt * (xs / mu + 1.0))
        return torch.where(x > 0, val, torch.zeros_like(val))

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """With the log link, (x - mu)^2 / x = e^v - 2 mu + mu^2 e^-v:
        (log lam - log 2pi) / 2 + lam / mu - v / 2 - lam e^v / (2 mu^2)
        - lam e^-v / 2."""
        if not _is_log_link(bijector):
            return None
        mu, lam = self.mu, self.lam
        lp = (0.5 * (torch.log(lam) - LOG2PI) + lam / mu - 0.5 * y
              - lam / (2.0 * mu * mu) * torch.exp(y) - 0.5 * lam * torch.exp(-y))
        return (torch.exp(y) if want_x else None), lp

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        """Michael, Schucany and Haas's transformation."""
        shape = tuple(sample_shape) + self.batch_shape
        mu, lam = self.mu, self.lam
        nu = R.normal(generator, shape, mu)
        y = nu * nu
        x = mu + mu * mu * y / (2 * lam) - mu / (2 * lam) * torch.sqrt(
            4 * mu * lam * y + mu * mu * y * y)
        z = R.uniform(generator, shape, mu)
        return torch.where(z <= mu / (mu + x), x, mu * mu / x)


@dataclass(frozen=True)
class TriangularDist(LeafDistribution):
    """The triangular distribution on (a, b) with mode c."""

    a: object = 0.0
    b: object = 1.0
    c: object = 0.5

    _params = ("a", "b", "c")

    def logpdf(self, x):
        a, b, c = self.a, self.b, self.c
        left = 2.0 * (x - a) / ((b - a) * (c - a))
        right = 2.0 * (b - x) / ((b - a) * (b - c))
        pdf = torch.where(x < c, left, right)
        pdf = torch.where((x < a) | (x > b), torch.zeros_like(pdf), pdf)
        return torch.log(pdf)

    def cdf(self, x):
        a, b, c = self.a, self.b, self.c
        xc = torch.minimum(torch.maximum(x, a), b)
        left = (xc - a) ** 2 / ((b - a) * (c - a))
        right = 1.0 - (b - xc) ** 2 / ((b - a) * (b - c))
        return torch.where(xc <= c, left, right)

    def quantile(self, q):
        a, b, c = self.a, self.b, self.c
        return torch.where(q < (c - a) / (b - a),
                           a + torch.sqrt(torch.clamp_min(q, 0.0) * (b - a) * (c - a)),
                           b - torch.sqrt(torch.clamp_min(1.0 - q, 0.0) * (b - a) * (b - c)))

    @property
    def support(self):
        return interval(_static_bound(self.a, "TriangularDist", "a"),
                        _static_bound(self.b, "TriangularDist", "b"))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        a, b, c = self.a, self.b, self.c
        u = R.uniform(generator, shape, a)
        return torch.where(u < (c - a) / (b - a), a + torch.sqrt(u * (b - a) * (c - a)),
                           b - torch.sqrt((1.0 - u) * (b - a) * (b - c)))
