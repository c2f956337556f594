"""Univariate families, part 3, PyTorch counterpart of
`tpu_bijectors/dists/univariate3.py`: Erlang, LogUniform, JohnsonSU,
NormalCanon, Biweight, Triweight, SymTriangularDist,
PGeneralizedGaussian, Rician, Lindley, Kolmogorov, the noncentral
families (chi-squared, beta and F as Poisson mixtures summed over a
window of 128 terms centred on the dominant one; t by a 96-point
Gauss-Hermite rule), NormalInverseGaussian (Bessel K1 by Abramowitz and
Stegun's polynomials), SkewedExponentialPower, StudentizedRange (a
96 x 96-point Gauss-Legendre double integral) and KSOneSided.

None has a slab form. The traced entries of the fused evaluation
(`vectorize/fused_traced.py`) serve those whose linked density traces
into the tape's opcodes, as the JAX package's plan does; Rician's and
NormalInverseGaussian's Bessel functions of the state, the noncentral
series' argmax windows and StudentizedRange's ndtr of the state decline
in both packages, and those leaves take the composed path, plain torch
on either device as the JAX package computes them in jnp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import _random as R
from .base import LeafDistribution, interval, positive, unit_interval
from .univariate import _static_bound
from .univariate2 import InverseGaussian, _kernel_support

LOG2PI = math.log(2.0 * math.pi)
LOGPI = math.log(math.pi)
LOG2 = math.log(2.0)

# the terms of the Poisson-mixture series
_N_SERIES = 128
# the coarse grid of the window's centre: every index below 32, then powers
# of two to 2^20 (static: no shape depends on a parameter)
_SERIES_COARSE = np.concatenate([np.arange(0.0, 32.0), 2.0 ** np.arange(5, 21)])


def _windowed_series_logsumexp(log_term, like, n=_N_SERIES):
    """logsumexp over j = 0, 1, 2, ... of `log_term(j)` (j a trailing axis),
    truncated to an n-term window centred on the dominant term: the argmax
    on `_SERIES_COARSE`, then three refinements on 33-point grids; a peak
    wider than the window (sqrt(j*/2) > n/16) is summed at a stride s with
    log s added (the JAX package's `_windowed_series_logsumexp`)."""
    kw = dict(dtype=like.dtype, device=like.device)
    jg = torch.as_tensor(_SERIES_COARSE, **kw)
    jc = jg[torch.argmax(log_term(jg), -1)]
    lin = torch.linspace(-1.0, 1.0, 33, **kw)
    for frac in (0.75, 0.05, 0.0035):
        half = torch.clamp_min(frac * jc, 4.0)
        grid = torch.clamp_min(jc[..., None] + lin * half[..., None], 0.0)
        pick = torch.argmax(log_term(grid), -1)
        jc = torch.take_along_dim(grid, pick[..., None], -1)[..., 0]
    sigma = torch.sqrt(torch.clamp_min(jc, 1.0) / 2.0)
    s = torch.clamp_min(torch.ceil(16.0 * sigma / n), 1.0)
    j0 = torch.floor(torch.clamp_min(jc - s * (n / 2), 0.0))
    j = j0[..., None] + s[..., None] * torch.arange(n, **kw)
    return torch.logsumexp(log_term(j), -1) + torch.log(s)


# ---------------------------------------------------------------------------
# closed-form families
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Erlang(LeafDistribution):
    """Erlang(k, theta): Gamma with shape k and scale theta."""

    k: object = 1.0
    theta: object = 1.0

    _params = ("k", "theta")
    _cdf_fd = ("k",)  # gammainc has no derivative in a

    def logpdf(self, x):
        k, th = self.k, self.theta
        return (k - 1.0) * torch.log(x) - x / th - k * torch.log(th) - torch.lgamma(k)

    def cdf(self, x):
        return torch.special.gammainc(self.k, x / self.theta)

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.theta * R.gamma(generator, self.k, shape)


@dataclass(frozen=True)
class LogUniform(LeafDistribution):
    a: object = 1.0
    b: object = math.e

    _params = ("a", "b")

    def logpdf(self, x):
        return -torch.log(x) - torch.log(torch.log(self.b) - torch.log(self.a))

    def cdf(self, x):
        la, lb = torch.log(self.a), torch.log(self.b)
        return (torch.log(x) - la) / (lb - la)

    def quantile(self, q):
        la, lb = torch.log(self.a), torch.log(self.b)
        return torch.exp(la + q * (lb - la))

    @property
    def support(self):
        return interval(_static_bound(self.a, "LogUniform", "a"),
                        _static_bound(self.b, "LogUniform", "b"))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        la, lb = torch.log(self.a), torch.log(self.b)
        return torch.exp(la + R.uniform(generator, shape, self.a) * (lb - la))


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


@dataclass(frozen=True)
class NormalCanon(LeafDistribution):
    """The normal in canonical form: potential eta, precision lam (mean
    eta / lam)."""

    eta: object = 0.0
    lam: object = 1.0

    _params = ("eta", "lam")

    def logpdf(self, x):
        lam = self.lam
        return 0.5 * (torch.log(lam) - LOG2PI) - 0.5 * lam * (x - self.eta / lam) ** 2

    def cdf(self, x):
        lam = self.lam
        return torch.special.ndtr((x - self.eta / lam) * torch.sqrt(lam))

    def quantile(self, q):
        lam = self.lam
        return self.eta / lam + torch.special.ndtri(q) / torch.sqrt(lam)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        lam = self.lam
        return self.eta / lam + R.normal(generator, shape, lam) / torch.sqrt(lam)


@dataclass(frozen=True)
class Biweight(LeafDistribution):
    """The (15/16)(1 - z^2)^2 kernel on [mu - s, mu + s]."""

    mu: object = 0.0
    s: object = 1.0

    _params = ("mu", "s")

    def logpdf(self, x):
        z = (x - self.mu) / self.s
        return math.log(15.0 / 16.0) + 2.0 * torch.log1p(-z * z) - torch.log(self.s)

    def cdf(self, x):
        z = torch.clamp((x - self.mu) / self.s, -1.0, 1.0)
        return 0.5 + (15.0 * z - 10.0 * z ** 3 + 3.0 * z ** 5) / 16.0

    @property
    def support(self):
        return _kernel_support(self, "Biweight")

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        c = torch.full_like(self.s, 3.0)
        return self.mu + self.s * (2.0 * R.beta(generator, c, c, shape) - 1.0)


@dataclass(frozen=True)
class Triweight(LeafDistribution):
    """The (35/32)(1 - z^2)^3 kernel on [mu - s, mu + s]."""

    mu: object = 0.0
    s: object = 1.0

    _params = ("mu", "s")

    def logpdf(self, x):
        z = (x - self.mu) / self.s
        return math.log(35.0 / 32.0) + 3.0 * torch.log1p(-z * z) - torch.log(self.s)

    def cdf(self, x):
        z = torch.clamp((x - self.mu) / self.s, -1.0, 1.0)
        return 0.5 + (35.0 * z - 35.0 * z ** 3 + 21.0 * z ** 5 - 5.0 * z ** 7) / 32.0

    @property
    def support(self):
        return _kernel_support(self, "Triweight")

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        c = torch.full_like(self.s, 4.0)
        return self.mu + self.s * (2.0 * R.beta(generator, c, c, shape) - 1.0)


@dataclass(frozen=True)
class SymTriangularDist(LeafDistribution):
    """The (1 - |z|) / s triangle on [mu - s, mu + s]."""

    mu: object = 0.0
    s: object = 1.0

    _params = ("mu", "s")

    def logpdf(self, x):
        z = (x - self.mu) / self.s
        return torch.log1p(-torch.abs(z)) - torch.log(self.s)

    def cdf(self, x):
        z = torch.clamp((x - self.mu) / self.s, -1.0, 1.0)
        return torch.where(z < 0, 0.5 * (1.0 + z) ** 2, 1.0 - 0.5 * (1.0 - z) ** 2)

    def quantile(self, q):
        z = torch.where(q < 0.5, torch.sqrt(torch.clamp_min(2.0 * q, 0.0)) - 1.0,
                        1.0 - torch.sqrt(torch.clamp_min(2.0 * (1.0 - q), 0.0)))
        return self.mu + self.s * z

    @property
    def support(self):
        return _kernel_support(self, "SymTriangularDist")

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = R.uniform(generator, shape, self.mu) - R.uniform(generator, shape, self.mu)
        return self.mu + self.s * u


@dataclass(frozen=True)
class PGeneralizedGaussian(LeafDistribution):
    """The p-generalized Gaussian (scipy's gennorm): p / (2 a Gamma(1/p))
    exp(-|z|^p)."""

    p: object = 2.0
    mu: object = 0.0
    alpha: object = 1.0

    _params = ("p", "mu", "alpha")
    _cdf_fd = ("p",)  # gammainc has no derivative in a

    def logpdf(self, x):
        p, a = self.p, self.alpha
        z = torch.abs((x - self.mu) / a)
        return torch.log(p) - LOG2 - torch.log(a) - torch.lgamma(1.0 / p) - z ** p

    def cdf(self, x):
        p = self.p
        z = (x - self.mu) / self.alpha
        g = torch.special.gammainc(1.0 / p, torch.abs(z) ** p)
        return 0.5 + 0.5 * torch.sign(z) * g

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        p = self.p
        g = R.gamma(generator, 1.0 / p, shape)
        sign = 2.0 * R.bernoulli(generator, torch.full_like(p, 0.5), shape) - 1.0
        return self.mu + self.alpha * sign * g ** (1.0 / p)


@dataclass(frozen=True)
class Rician(LeafDistribution):
    """Rice(nu, sigma): x / s^2 exp(-(x^2 + nu^2) / (2 s^2)) I0(x nu / s^2)."""

    nu: object = 0.0
    sigma: object = 1.0

    _params = ("nu", "sigma")

    def logpdf(self, x):
        nu = self.nu
        s2 = self.sigma ** 2
        t = x * nu / s2
        log_i0 = torch.log(torch.special.i0e(t)) + torch.abs(t)
        return torch.log(x) - torch.log(s2) - (x * x + nu * nu) / (2.0 * s2) + log_i0

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        z1 = R.normal(generator, shape, self.nu)
        z2 = R.normal(generator, shape, self.nu)
        return torch.sqrt((self.nu + self.sigma * z1) ** 2 + (self.sigma * z2) ** 2)


@dataclass(frozen=True)
class Lindley(LeafDistribution):
    """Lindley(theta): theta^2 / (1 + theta) (1 + x) e^(-theta x)."""

    theta: object = 1.0

    _params = ("theta",)

    def logpdf(self, x):
        th = self.theta
        return 2.0 * torch.log(th) - torch.log1p(th) + torch.log1p(x) - th * x

    def cdf(self, x):
        th = self.theta
        return 1.0 - (1.0 + th * x / (1.0 + th)) * torch.exp(-th * x)

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        """Exp(theta) with probability theta / (1 + theta), else
        Gamma(2, theta)."""
        shape = tuple(sample_shape) + self.batch_shape
        th = self.theta
        pick_exp = R.uniform(generator, shape, th) < th / (1.0 + th)
        g1 = R.exponential(generator, shape, th) / th
        g2 = R.gamma(generator, torch.full_like(th, 2.0), shape) / th
        return torch.where(pick_exp, g1, g2)


@dataclass(frozen=True)
class Kolmogorov(LeafDistribution):
    """The limiting distribution of the Kolmogorov-Smirnov statistic
    sup|B(t)|: its density by the two ten-term theta series, the small-x
    (Jacobi) one below x = 1 and the large-x one above."""

    def _k(self, like):
        return torch.arange(1.0, 11.0, dtype=like.dtype, device=like.device)

    def _pdf_large(self, x):
        k = self._k(x)
        t = torch.exp(-2.0 * (k * k) * (x[..., None] ** 2))
        return 8.0 * x * torch.sum(((-1.0) ** (k - 1.0)) * k * k * t, -1)

    def _pdf_small(self, x):
        xs = torch.clamp_min(x, 0.05)
        k = self._k(x)
        a = ((2.0 * k - 1.0) ** 2) * (math.pi ** 2)
        e = torch.exp(-a / (8.0 * xs[..., None] ** 2))
        s = torch.sum(e * (a / (4.0 * xs[..., None] ** 2) - 1.0), -1)
        return torch.where(x > 0.04, math.sqrt(2.0 * math.pi) / (xs * xs) * s, 0.0)

    def logpdf(self, x):
        pdf = torch.where(x < 1.0, self._pdf_small(x), self._pdf_large(x))
        return torch.log(torch.clamp_min(pdf, torch.finfo(pdf.dtype).tiny))

    def cdf(self, x):
        xs = torch.clamp_min(x, 0.05)
        k = self._k(x)
        large = 1.0 - 2.0 * torch.sum(
            ((-1.0) ** (k - 1.0)) * torch.exp(-2.0 * (k * k) * (x[..., None] ** 2)), -1)
        small = math.sqrt(2.0 * math.pi) / xs * torch.sum(
            torch.exp(-(((2.0 * k - 1.0) ** 2) * (math.pi ** 2)) / (8.0 * xs[..., None] ** 2)), -1)
        return torch.where(x < 1.0, torch.where(x > 0.04, small, 0.0), large)

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        """The inverse cdf by 60 bisection steps on [0.1, 4]."""
        shape = tuple(sample_shape)
        u = 1e-12 + (1.0 - 2e-12) * R.uniform(generator, shape, self._like)
        lo, hi = torch.full_like(u, 0.1), torch.full_like(u, 4.0)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            go_hi = self.cdf(mid) < u
            lo, hi = torch.where(go_hi, mid, lo), torch.where(go_hi, hi, mid)
        return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# the noncentral families
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NoncentralChisq(LeafDistribution):
    """ncx2(k, lam): the Poisson(lam / 2) mixture of central chi^2_{k+2j}."""

    k: object = 1.0
    lam: object = 1.0

    _params = ("k", "lam")

    def logpdf(self, x):
        k, lam = self.k, self.lam
        lx = torch.log(x)[..., None]
        xx = x[..., None]

        def lt(j):
            h = 0.5 * (k + 2.0 * j)
            return (-0.5 * lam + j * torch.log(0.5 * lam) - torch.lgamma(j + 1.0)
                    + (h - 1.0) * lx - 0.5 * xx - h * LOG2 - torch.lgamma(h))

        return _windowed_series_logsumexp(lt, x)

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        j = R.poisson(generator, 0.5 * self.lam, shape)
        return 2.0 * R.gamma(generator, 0.5 * (self.k + 2.0 * j), shape)


@dataclass(frozen=True)
class NoncentralBeta(LeafDistribution):
    """The Poisson(lam / 2) mixture of Beta(a + j, b)."""

    a: object = 1.0
    b: object = 1.0
    lam: object = 1.0

    _params = ("a", "b", "lam")

    def logpdf(self, x):
        a, b, lam = self.a, self.b, self.lam
        lx, l1mx = torch.log(x)[..., None], torch.log1p(-x)[..., None]

        def lt(j):
            aj = a + j
            return (-0.5 * lam + j * torch.log(0.5 * lam) - torch.lgamma(j + 1.0)
                    + (aj - 1.0) * lx + (b - 1.0) * l1mx
                    - (torch.lgamma(aj) + torch.lgamma(b) - torch.lgamma(aj + b)))

        return _windowed_series_logsumexp(lt, x)

    @property
    def support(self):
        return unit_interval()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        j = R.poisson(generator, 0.5 * self.lam, shape)
        return R.beta(generator, self.a + j, self.b.expand(shape), shape)


@dataclass(frozen=True)
class NoncentralF(LeafDistribution):
    """ncF(d1, d2, lam) = (ncx2(d1, lam) / d1) / (chi2(d2) / d2)."""

    d1: object = 1.0
    d2: object = 1.0
    lam: object = 1.0

    _params = ("d1", "d2", "lam")

    def logpdf(self, x):
        d1, d2, lam = self.d1, self.d2, self.lam
        h2 = 0.5 * d2
        lx = torch.log(x)[..., None]
        lr = torch.log(d2 / (d2 + d1 * x))[..., None]

        def lt(j):
            h1 = 0.5 * d1 + j
            return (-0.5 * lam + j * torch.log(0.5 * lam) - torch.lgamma(j + 1.0)
                    + h1 * (torch.log(d1) - torch.log(d2)) + (h1 + h2) * lr
                    + (h1 - 1.0) * lx
                    - (torch.lgamma(h1) + torch.lgamma(h2) - torch.lgamma(h1 + h2)))

        return _windowed_series_logsumexp(lt, x)

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        num = NoncentralChisq(self.d1, self.lam, device=self.d1.device).sample(generator,
                                                                         sample_shape)
        den = 2.0 * R.gamma(generator, 0.5 * self.d2, shape)
        return (num / self.d1) / (den / self.d2)


_NCT_GH_NODES, _NCT_GH_WEIGHTS = np.polynomial.hermite.hermgauss(96)


@dataclass(frozen=True)
class NoncentralT(LeafDistribution):
    """nct(nu, delta) = (Z + delta) / sqrt(chi2_nu / nu): the density as
    the scale-mixture integral over s = log r, a 96-point Gauss-Hermite
    rule centred on the integrand's mode r* with its Laplace width (the
    JAX family's)."""

    nu: object = 1.0
    delta: object = 0.0

    _params = ("nu", "delta")

    def logpdf(self, t):
        nu, d = self.nu, self.delta
        kw = dict(dtype=t.dtype, device=t.device)
        a = nu + t * t
        td = t * d
        rstar = (td + torch.sqrt(td * td + 4.0 * (nu + 1.0) * a)) / (2.0 * a)
        sigma = 1.0 / torch.sqrt(td * rstar + 2.0 * (nu + 1.0))
        x = torch.as_tensor(_NCT_GH_NODES, **kw)
        logw = torch.as_tensor(np.log(_NCT_GH_WEIGHTS), **kw)
        s = torch.log(rstar)[..., None] + math.sqrt(2.0) * sigma[..., None] * x
        r = torch.exp(s)
        g = ((nu[..., None] + 1.0) * s - 0.5 * nu[..., None] * r * r
             - 0.5 * torch.square(t[..., None] * r - d[..., None]))
        log_int = torch.logsumexp(g + x * x + logw, -1) + 0.5 * LOG2 + torch.log(sigma)
        logC = (LOG2 + 0.5 * nu * (torch.log(nu) - LOG2) - torch.lgamma(0.5 * nu)
                - 0.5 * math.log(2.0 * math.pi))
        return logC + log_int

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        z = R.normal(generator, shape, self.nu) + self.delta
        v = 2.0 * R.gamma(generator, 0.5 * self.nu, shape)
        return z / torch.sqrt(v / self.nu)


# ---------------------------------------------------------------------------
# NormalInverseGaussian (Bessel K1) and SkewedExponentialPower
# ---------------------------------------------------------------------------


def _log_k1(x):
    """log K1(x) by Abramowitz and Stegun 9.8.7 (x <= 2) and 9.8.8 (x > 2)
    (relative error about 2e-7), the JAX package's `_log_k1`."""
    tiny = torch.finfo(x.dtype).tiny
    xs = torch.clamp_min(x, 1e-30)
    t = torch.clamp_max(xs, 2.0)
    q = (t / 2.0) ** 2
    p_small = 1.0 + q * (0.15443144 + q * (-0.67278579 + q * (-0.18156897 + q * (
        -0.01919402 + q * (-0.00110404 + q * (-0.00004686))))))
    i1 = torch.special.i1e(t) * torch.exp(t)
    k1_small = (t * torch.log(t / 2.0) * i1 + p_small) / t
    log_k1_small = torch.log(torch.clamp_min(k1_small, tiny))
    r = 2.0 / torch.clamp_min(xs, 2.0)
    p_large = 1.25331414 + r * (0.23498619 + r * (-0.03655620 + r * (0.01504268 + r * (
        -0.00780353 + r * (0.00325614 + r * (-0.00068245))))))
    log_k1_large = torch.log(p_large) - xs - 0.5 * torch.log(xs)
    return torch.where(xs <= 2.0, log_k1_small, log_k1_large)


@dataclass(frozen=True)
class NormalInverseGaussian(LeafDistribution):
    """NIG(mu, alpha, beta, delta): the normal variance-mean mixture with an
    InverseGaussian(delta / gamma, delta^2) mixing law, gamma =
    sqrt(alpha^2 - beta^2)."""

    mu: object = 0.0
    alpha: object = 1.0
    beta: object = 0.0
    delta: object = 1.0

    _params = ("mu", "alpha", "beta", "delta")

    def logpdf(self, x):
        mu, a, b, de = self.mu, self.alpha, self.beta, self.delta
        g = torch.sqrt(a * a - b * b)
        r = torch.sqrt(de * de + (x - mu) ** 2)
        return (torch.log(a * de) - LOGPI + _log_k1(a * r) - torch.log(r) + de * g
                + b * (x - mu))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        a, b, de = self.alpha, self.beta, self.delta
        g = torch.sqrt(a * a - b * b)
        w = InverseGaussian(de / g, de * de, device=de.device).sample(generator, shape)
        z = R.normal(generator, shape, a)
        return self.mu + b * w + torch.sqrt(w) * z


@dataclass(frozen=True)
class SkewedExponentialPower(LeafDistribution):
    """SEPD(mu, sigma, p, alpha) (Zhu and Galbraith 2010, as Distributions.jl):
    1 / (2 sigma p^(1/p) Gamma(1 + 1/p)) exp(-|z / (2 a)|^p / p), a = alpha
    for z <= 0 else 1 - alpha."""

    mu: object = 0.0
    sigma: object = 1.0
    p: object = 2.0
    alpha: object = 0.5

    _params = ("mu", "sigma", "p", "alpha")

    def logpdf(self, x):
        s, p, al = self.sigma, self.p, self.alpha
        z = (x - self.mu) / s
        a = torch.where(z <= 0, al, 1.0 - al)
        return (-LOG2 - torch.log(s) - torch.log(p) / p - torch.lgamma(1.0 + 1.0 / p)
                - torch.abs(z / (2.0 * a)) ** p / p)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        p, al = self.p, self.alpha
        left = R.uniform(generator, shape, p) < al
        u = (p * R.gamma(generator, 1.0 / p, shape)) ** (1.0 / p)
        z = torch.where(left, -2.0 * al * u, 2.0 * (1.0 - al) * u)
        return self.mu + self.sigma * z


# ---------------------------------------------------------------------------
# StudentizedRange and KSOneSided
# ---------------------------------------------------------------------------

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(96)


def _gl(a, b, like):
    """The 96 Gauss-Legendre nodes and weights on [a, b]."""
    kw = dict(dtype=like.dtype, device=like.device)
    x = 0.5 * (b - a) * (_GL_NODES + 1.0) + a
    return torch.as_tensor(x, **kw), torch.as_tensor(0.5 * (b - a) * _GL_WEIGHTS, **kw)


@dataclass(frozen=True)
class StudentizedRange(LeafDistribution):
    """q(nu, k) = range(Z_1 .. Z_k) / sqrt(chi2_nu / nu): the density as
    scipy's double integral by 96-point Gauss-Legendre rules in s on
    [1e-6, 8] and in z on [-9, 9]."""

    nu: object = 1.0
    k: object = 2.0

    _params = ("nu", "k")

    def logpdf(self, q):
        nu, k = self.nu, self.k
        tiny = torch.finfo(q.dtype).tiny
        s_x, s_w = _gl(1e-6, 8.0, q)
        z, z_w = _gl(-9.0, 9.0, q)

        def phi(u):
            return torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)

        qs = q[..., None] * s_x  # (..., S)
        zq = z - qs[..., None]  # (..., S, Z)
        # (Phi(z) - Phi(z - qs))^(k - 2) through a clamped exp o log: pow's
        # derivative is NaN at base 0 with exponent 0 (k = 2)
        diff = torch.clamp_min(torch.special.ndtr(z) - torch.special.ndtr(zq), tiny)
        inner = torch.sum(phi(z) * z_w * phi(zq) * torch.exp((k - 2.0) * torch.log(diff)), -1)
        outer = torch.sum(s_w * s_x ** (nu - 1.0) * torch.exp(-0.5 * nu * s_x * s_x) * s_x
                          * inner, -1)
        log_c = (torch.log(k) + torch.log(k - 1.0) + 0.5 * nu * torch.log(nu)
                 - torch.lgamma(0.5 * nu) - (0.5 * nu - 1.0) * LOG2)
        return log_c + torch.log(torch.clamp_min(outer, tiny))

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        n_k = int(_static_bound(self.k, "StudentizedRange", "k"))
        z = R.normal(generator, shape + (n_k,), self.nu)
        rng = torch.amax(z, -1) - torch.amin(z, -1)
        v = 2.0 * R.gamma(generator, 0.5 * self.nu, shape)
        return rng / torch.sqrt(v / self.nu)


@dataclass(frozen=True)
class KSOneSided(LeafDistribution):
    """The one-sided Kolmogorov-Smirnov statistic D_n^+ for n draws: the
    cdf by the Birnbaum-Tingey sum, the density its derivative."""

    n: int = 10

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "n", int(self.n))
        super().__post_init__(device, dtype)

    def _terms(self, d):
        """The Birnbaum-Tingey summands T_j = C(n, j) a^(j-1) b^(n-j) (0
        past the mask), a = d + j/n, b = 1 - d - j/n, and the safe a, b."""
        n = self.n
        j = torch.arange(n + 1, dtype=d.dtype, device=d.device)
        mask = j <= n * (1.0 - d[..., None])
        tiny = torch.finfo(d.dtype).tiny
        a = torch.clamp_min(d[..., None] + j / n, tiny)
        b = torch.clamp_min(1.0 - d[..., None] - j / n, tiny)
        logc = math.lgamma(n + 1.0) - torch.lgamma(j + 1.0) - torch.lgamma(n - j + 1.0)
        t = torch.where(mask, torch.exp(logc + (j - 1.0) * torch.log(a) + (n - j) * torch.log(b)),
                        0.0)
        # where b sits at its clamp (masked, or on the mask's edge) (n-j)/b
        # would overflow: a harmless denominator, t is 0 there
        b_safe = torch.where(mask & (b > tiny), b, 1.0)
        return t, a, b_safe, j

    def cdf(self, d):
        t, _, _, _ = self._terms(d)
        return 1.0 - d * torch.sum(t, -1)

    def logpdf(self, d):
        """cdf = 1 - d S, so pdf = -S + d sum_j T_j ((n-j)/b - (j-1)/a)."""
        t, a, b, j = self._terms(d)
        S = torch.sum(t, -1)
        dS = torch.sum(t * ((self.n - j) / b - (j - 1.0) / a), -1)
        pdf = -S + d * dS
        return torch.log(torch.clamp_min(pdf, torch.finfo(d.dtype).tiny))

    @property
    def support(self):
        return unit_interval()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape)
        u = torch.sort(R.uniform(generator, shape + (self.n,), self._like), -1).values
        i = torch.arange(1, self.n + 1, dtype=u.dtype, device=u.device) / self.n
        return torch.amax(i - u, -1)
