"""Univariate families, part 2, PyTorch counterpart of
`tpu_bijectors/dists/univariate2.py`: BetaPrime and InverseGaussian (log
link) and TriangularDist (logit link), which no slab form serves; the
traced entries of the fused evaluation (`vectorize/fused_traced.py`) do.

BetaPrime and InverseGaussian have telescoped `fused_linked_logdensity`
hooks, as the port's other log-link families do: written in v = log x,
their linked densities are finite or -inf at |v| ~ 1e10, where the
generic composition forms inf - inf or inf / inf (the JAX package has no
such hook for these two; ROADMAP's differences from the reference).

FDist, VonMises, Semicircle, Cosine, Epanechnikov, GeneralizedPareto,
GeneralizedExtremeValue and Gompertz have no hook in either package: the
traced entries serve them where their densities trace (VonMises' and
Cosine's through the tape's cos opcode), as the JAX package's plan does;
GeneralizedPareto's density selects on |xi| < 1e-12, a boolean the trace
would hoist, and declines in both. NegativeBinomial is discrete (the
Identity link).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils import log1pexp
from . import _random as R
from ._special import betainc
from .base import (
    DiscreteDistribution,
    LeafDistribution,
    Support,
    interval,
    lower_bounded,
    positive,
    real_line,
)
from .univariate import _fx, _is_log_link, _static_bound

LOG2PI = math.log(2.0 * math.pi)
LOG2 = math.log(2.0)
LOGPI = math.log(math.pi)


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


@dataclass(frozen=True)
class FDist(LeafDistribution):
    d1: object = 1.0
    d2: object = 1.0

    _params = ("d1", "d2")
    _cdf_fd = ("d1", "d2")  # betainc has no derivative in a or b

    def logpdf(self, x):
        d1, d2 = self.d1, self.d2
        h1, h2 = 0.5 * d1, 0.5 * d2
        return (h1 * (torch.log(d1) - torch.log(d2)) + (h1 - 1.0) * torch.log(x)
                - (h1 + h2) * torch.log1p(d1 * x / d2)
                - (torch.lgamma(h1) + torch.lgamma(h2) - torch.lgamma(h1 + h2)))

    def cdf(self, x):
        d1, d2 = self.d1, self.d2
        xc = torch.clamp_min(x, 0.0)
        return betainc(0.5 * d1, 0.5 * d2, d1 * xc / (d1 * xc + d2))

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        g1 = R.gamma(generator, 0.5 * self.d1, shape)
        g2 = R.gamma(generator, 0.5 * self.d2, shape)
        return (g1 / self.d1) / (g2 / self.d2)


@dataclass(frozen=True)
class VonMises(LeafDistribution):
    """Von Mises on [-pi, pi] (the logit link of a bounded support)."""

    loc: object = 0.0
    kappa: object = 1.0

    _params = ("loc", "kappa")

    def logpdf(self, x):
        kappa = self.kappa
        return (kappa * torch.cos(x - self.loc) - LOG2PI
                - torch.log(torch.special.i0e(kappa)) - kappa)

    @property
    def support(self):
        return interval(-math.pi, math.pi)

    def sample(self, generator, sample_shape=()):
        """Best and Fisher's rejection sampler with 8 proposals a draw, the
        first accepted one kept (the first proposal where none is), as the
        JAX package's `_sample_rejectionless`."""
        shape = tuple(sample_shape) + self.batch_shape
        kappa = self.kappa
        n_prop = 8
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
        r = (1.0 + rho * rho) / (2.0 * rho)
        u1 = R.uniform(generator, (n_prop,) + shape, kappa)
        u2 = R.uniform(generator, (n_prop,) + shape, kappa)
        u3 = R.uniform(generator, (n_prop,) + shape, kappa)
        z = torch.cos(math.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept = (c * (2.0 - c) - u2 > 0) | (torch.log(c / u2) + 1.0 - c >= 0)
        theta = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
        idx = torch.argmax(accept.to(torch.uint8), dim=0)
        sel = torch.take_along_dim(theta, idx[None], dim=0)[0]
        return torch.remainder(sel + self.loc + math.pi, 2.0 * math.pi) - math.pi


@dataclass(frozen=True)
class Semicircle(LeafDistribution):
    radius: object = 1.0

    _params = ("radius",)

    def logpdf(self, x):
        r = self.radius
        return 0.5 * torch.log(r * r - x * x) + LOG2 - LOGPI - 2.0 * torch.log(r)

    def cdf(self, x):
        z = torch.clamp(x / self.radius, -1.0, 1.0)
        return 0.5 + z * torch.sqrt(1.0 - z * z) / math.pi + torch.asin(z) / math.pi

    @property
    def support(self):
        r = _static_bound(self.radius, "Semicircle", "radius")
        return interval(-r, r)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        half = torch.full_like(self.radius, 1.5)
        return self.radius * (2.0 * R.beta(generator, half, half, shape) - 1.0)


def _kernel_support(d, family):
    """[mu - s, mu + s] of a bounded kernel family, static."""
    mu = _static_bound(d.mu, family, "mu")
    s = _static_bound(d.s, family, "s")
    return interval(mu - s, mu + s)


@dataclass(frozen=True)
class Cosine(LeafDistribution):
    """The raised cosine on [mu - s, mu + s]."""

    mu: object = 0.0
    s: object = 1.0

    _params = ("mu", "s")

    def logpdf(self, x):
        z = (x - self.mu) / self.s
        return torch.log1p(torch.cos(math.pi * z)) - torch.log(2.0 * self.s)

    @staticmethod
    def _cdf_z(z):
        return 0.5 * (1.0 + z + torch.sin(math.pi * z) / math.pi)

    def cdf(self, x):
        return self._cdf_z(torch.clamp((x - self.mu) / self.s, -1.0, 1.0))

    @property
    def support(self):
        return _kernel_support(self, "Cosine")

    def sample(self, generator, sample_shape=()):
        """The inverse cdf by 60 bisection steps, as the JAX sampler's."""
        shape = tuple(sample_shape) + self.batch_shape
        u = R.uniform(generator, shape, self.mu)
        lo, hi = -torch.ones_like(u), torch.ones_like(u)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            go_hi = self._cdf_z(mid) < u
            lo, hi = torch.where(go_hi, mid, lo), torch.where(go_hi, hi, mid)
        return self.mu + self.s * (0.5 * (lo + hi))


@dataclass(frozen=True)
class Epanechnikov(LeafDistribution):
    mu: object = 0.0
    s: object = 1.0

    _params = ("mu", "s")

    def logpdf(self, x):
        z = (x - self.mu) / self.s
        return math.log(0.75) + torch.log1p(-z * z) - torch.log(self.s)

    def cdf(self, x):
        z = torch.clamp((x - self.mu) / self.s, -1.0, 1.0)
        return 0.25 * (2.0 + 3.0 * z - z ** 3)

    @property
    def support(self):
        return _kernel_support(self, "Epanechnikov")

    def sample(self, generator, sample_shape=()):
        """The median of three uniforms on [-1, 1]."""
        shape = tuple(sample_shape) + self.batch_shape
        u = 2.0 * R.uniform(generator, (3,) + shape, self.mu) - 1.0
        return self.mu + self.s * torch.median(u, dim=0).values


@dataclass(frozen=True)
class GeneralizedPareto(LeafDistribution):
    """GPD(mu, sigma, xi), support [mu, inf) (xi >= 0)."""

    mu: object = 0.0
    sigma: object = 1.0
    xi: object = 0.3

    _params = ("mu", "sigma", "xi")

    def logpdf(self, x):
        s, xi = self.sigma, self.xi
        z = (x - self.mu) / s
        return torch.where(torch.abs(xi) < 1e-12, -z - torch.log(s),
                           -(1.0 / xi + 1.0) * torch.log1p(xi * z) - torch.log(s))

    def cdf(self, x):
        s, xi = self.sigma, self.xi
        z = torch.clamp_min((x - self.mu) / s, 0.0)
        small = torch.abs(xi) < 1e-6
        xi_safe = torch.where(small, 1.0, xi)
        t = torch.clamp_min(1.0 + xi_safe * z, 0.0)
        general = -torch.expm1(-torch.log(torch.clamp_min(t, torch.finfo(t.dtype).tiny)) / xi_safe)
        general = torch.where(t > 0, general, 1.0)
        return torch.where(small, -torch.expm1(-z), general)

    def quantile(self, q):
        xi = self.xi
        small = torch.abs(xi) < 1e-6
        xi_safe = torch.where(small, 1.0, xi)
        l1mq = torch.log1p(-q)
        z = torch.where(small, -l1mq, torch.expm1(-xi_safe * l1mq) / xi_safe)
        return self.mu + self.sigma * z

    @property
    def support(self):
        return lower_bounded(_static_bound(self.mu, "GeneralizedPareto", "mu"))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = R.uniform(generator, shape, self.mu, tiny=True)
        xi = self.xi
        z = torch.where(torch.abs(xi) < 1e-12, -torch.log(u), torch.expm1(-xi * torch.log(u)) / xi)
        return self.mu + self.sigma * z


@dataclass(frozen=True)
class GeneralizedExtremeValue(LeafDistribution):
    """GEV(mu, sigma, xi); xi > 0: support [mu - sigma / xi, inf)."""

    mu: object = 0.0
    sigma: object = 1.0
    xi: object = 0.3

    _params = ("mu", "sigma", "xi")

    def logpdf(self, x):
        s, xi = self.sigma, self.xi
        t = 1.0 + xi * ((x - self.mu) / s)
        return -(1.0 / xi + 1.0) * torch.log(t) - t ** (-1.0 / xi) - torch.log(s)

    def cdf(self, x):
        s, xi = self.sigma, self.xi
        z = (x - self.mu) / s
        small = torch.abs(xi) < 1e-6
        xi_safe = torch.where(small, 1.0, xi)
        t = torch.clamp_min(1.0 + xi_safe * z, 0.0)
        logt = torch.log(torch.clamp_min(t, torch.finfo(t.dtype).tiny))
        general = torch.exp(-torch.exp(-logt / xi_safe))
        general = torch.where(t > 0, general, torch.where(xi > 0, 0.0, 1.0))
        return torch.where(small, torch.exp(-torch.exp(-z)), general)

    def quantile(self, q):
        xi = self.xi
        small = torch.abs(xi) < 1e-6
        xi_safe = torch.where(small, 1.0, xi)
        llq = torch.log(-torch.log(q))
        z = torch.where(small, -llq, torch.expm1(-xi_safe * llq) / xi_safe)
        return self.mu + self.sigma * z

    @property
    def support(self):
        """The bounded side follows the sign of xi: the parameters must be
        static (a single family), as the JAX family requires."""
        mu, s, xi = (_static_bound(getattr(self, k), "GeneralizedExtremeValue", k)
                     for k in ("mu", "sigma", "xi"))
        if xi > 0:
            return lower_bounded(mu - s / xi)
        if xi < 0:
            return Support("interval", -math.inf, mu - s / xi, False, True)
        return real_line()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = R.uniform(generator, shape, self.mu, tiny=True)
        g = -torch.log(u)
        return self.mu + self.sigma * (g ** (-self.xi) - 1.0) / self.xi


@dataclass(frozen=True)
class Gompertz(LeafDistribution):
    eta: object = 1.0
    b: object = 1.0

    _params = ("eta", "b")

    def logpdf(self, x):
        eta, b = self.eta, self.b
        return torch.log(b * eta) + b * x + eta * -torch.expm1(b * x)

    def cdf(self, x):
        xc = torch.clamp_min(x, 0.0)
        return -torch.expm1(-self.eta * torch.expm1(self.b * xc))

    def quantile(self, q):
        return torch.log1p(-torch.log1p(-q) / self.eta) / self.b

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = R.uniform(generator, shape, self.eta, tiny=True)
        return torch.log1p(-torch.log(u) / self.eta) / self.b


@dataclass(frozen=True)
class NegativeBinomial(DiscreteDistribution):
    """Failures before the r-th success (the Identity link)."""

    r: object = 1.0
    p: object = 0.5

    _params = ("r", "p")

    def logpdf(self, x):
        r, p = self.r, self.p
        x = _fx(x, p)
        return (torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0)
                + r * torch.log(p) + x * torch.log1p(-p))

    def sample(self, generator, sample_shape=()):
        """A Poisson draw at a Gamma(r)-distributed rate (p's odds)."""
        shape = tuple(sample_shape) + self.batch_shape
        lam = R.gamma(generator, self.r, shape) * ((1.0 - self.p) / self.p)
        return R.poisson(generator, lam, shape).long()

    def cdf(self, x):
        r, p = self.r, self.p
        k = torch.floor(_fx(x, p))
        c = betainc(r, torch.clamp_min(k, 0.0) + 1.0, p)
        return torch.where(k >= 0, c, torch.zeros_like(c))
