"""Univariate families, PyTorch counterpart of
`tpu_bijectors/dists/univariate.py`: the continuous families the fused
slab serves.

Real line (identity link): Normal, StudentT, Cauchy, Laplace, Logistic,
Gumbel. Positive half-line (log link): LogNormal, Exponential, Gamma,
InverseGamma, Chi, Weibull, Rayleigh, Frechet, HalfNormal, HalfCauchy.
Unit interval or (low, high) (logit link): Beta, LogitNormal, Uniform.
Lower-bounded (shifted-log link): Pareto, Levy.

With no closed form in the fused slab, served by its traced entries
(`vectorize/fused_traced.py`): Kumaraswamy and Arcsine (logit link) and
`Truncated(base, lower, upper)`, any scalar base renormalised by
cdf(upper) - cdf(lower) (the cdfs of Normal, StudentT, Cauchy, Logistic,
Gumbel and LogNormal are here). SkewNormal's density reaches log_ndtr of
the state, which those entries decline. Chisq (log link) takes a traced
entry too.

The discrete families (Identity link, `DiscreteDistribution`): Poisson,
Bernoulli, Binomial, Geometric and Categorical, their `logpdf` the pmf's
log (plain torch: its lgamma of the state declines the traced entries in
both packages), their draws int64.

Parameters broadcast: a family with (n,) parameters is n families side by
side (`product.arraydist`). Every family with a transformed support has a
telescoped `fused_linked_logdensity` hook, as in the JAX package: with
its registry link the linked density is written in v directly, so it is
finite (or -inf, never NaN) at |v| ~ 1e10, where exp(v) or sigmoid(v)
saturate and the generic composition forms inf - inf. A hook declines
(returns None) for any other link.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..bijectors.scalar import Truncated as TruncatedLink
from ..utils import clamp, log1pexp
from . import _random as R
from ._special import betainc
from .base import (
    DiscreteDistribution,
    Distribution,
    LeafDistribution,
    Support,
    first_param,
    interval,
    lower_bounded,
    positive,
    unit_interval,
)

LOG2PI = math.log(2.0 * math.pi)
LOG2 = math.log(2.0)
LOGPI = math.log(math.pi)


def _is_log_link(b) -> bool:
    """True when the registry link is x -> log(x): the lower-only
    Truncated(0, inf) branch the positive support resolves to
    (reference truncated.jl:35)."""
    return (
        type(b) is TruncatedLink
        and b.lower_finite
        and not b.upper_finite
        and float(b.lb) == 0.0
    )


def _is_interval_logit_link(b, lo, hi) -> bool:
    """True when the registry link is the logit rescale over (lo, hi): the
    both-finite Truncated(lo, hi) branch (y = logit((x-lo)/(hi-lo)),
    reference truncated.jl:20-31)."""
    return (
        type(b) is TruncatedLink
        and b.lower_finite
        and b.upper_finite
        and float(b.lb) == float(lo)
        and float(b.ub) == float(hi)
    )


def _is_shifted_log_link(b, lo) -> bool:
    """True when the registry link is y = log(x - lo): the lower-only
    Truncated branch of a lower-bounded support such as Pareto's or Levy's
    (reference truncated.jl:35, src/transformed_distribution.jl:135)."""
    return (
        type(b) is TruncatedLink
        and b.lower_finite
        and not b.upper_finite
        and float(b.lb) == float(lo)
    )


def _static_bound(t, family, name):
    """A support bound as a float: the registry's link needs one bound for
    the whole family."""
    if t.ndim != 0:
        raise NotImplementedError(
            f"{family} with a per-element {name} has no single support; "
            "per-element bounds are not ported"
        )
    return float(t)


# ---------------------------------------------------------------------------
# real line (identity link: the linked density is logpdf)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Normal(LeafDistribution):
    loc: object = 0.0
    scale: object = 1.0

    _params = ("loc", "scale")

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + LOG2PI) - torch.log(self.scale)

    def cdf(self, x):
        return torch.special.ndtr((x - self.loc) / self.scale)

    def quantile(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.loc + self.scale * R.normal(generator, shape, self.loc)


@dataclass(frozen=True)
class StudentT(LeafDistribution):
    """Student's t with `df` degrees of freedom, location and scale."""

    df: object = 1.0
    loc: object = 0.0
    scale: object = 1.0

    _params = ("df", "loc", "scale")
    _cdf_fd = ("df",)  # betainc has no derivative in a or b

    def logpdf(self, x):
        v = self.df
        z = (x - self.loc) / self.scale
        lognorm = torch.lgamma(0.5 * (v + 1.0)) - torch.lgamma(0.5 * v) - 0.5 * (
            torch.log(v) + LOGPI
        )
        return lognorm - 0.5 * (v + 1.0) * torch.log1p(z * z / v) - torch.log(self.scale)

    def cdf(self, x):
        v = self.df
        z = (x - self.loc) / self.scale
        ib = betainc(0.5 * v, torch.full_like(v, 0.5), v / (v + z * z))
        return torch.where(z >= 0, 1.0 - 0.5 * ib, 0.5 * ib)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.loc + self.scale * R.student_t(generator, self.df, shape, self.loc)


@dataclass(frozen=True)
class Cauchy(LeafDistribution):
    loc: object = 0.0
    scale: object = 1.0

    _params = ("loc", "scale")

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -LOGPI - torch.log(self.scale) - torch.log1p(z * z)

    def cdf(self, x):
        return torch.atan((x - self.loc) / self.scale) / math.pi + 0.5

    def quantile(self, q):
        return self.loc + self.scale * torch.tan(math.pi * (q - 0.5))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.loc + self.scale * R.cauchy(generator, shape, self.loc)


@dataclass(frozen=True)
class Laplace(LeafDistribution):
    loc: object = 0.0
    scale: object = 1.0

    _params = ("loc", "scale")

    def logpdf(self, x):
        z = torch.abs(x - self.loc) / self.scale
        return -z - LOG2 - torch.log(self.scale)

    def cdf(self, x):
        z = (x - self.loc) / self.scale
        return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))

    def quantile(self, q):
        # both branches by where (not sign and abs): at q = 1/2 the
        # derivative is the one-sided 2 scale, not a kink's zero
        return self.loc + self.scale * torch.where(
            q < 0.5, torch.log(2.0 * q), -torch.log(2.0 * (1.0 - q)))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.loc + self.scale * R.laplace(generator, shape, self.loc)


@dataclass(frozen=True)
class Logistic(LeafDistribution):
    loc: object = 0.0
    scale: object = 1.0

    _params = ("loc", "scale")

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -z - 2.0 * log1pexp(-z) - torch.log(self.scale)

    def cdf(self, x):
        return torch.sigmoid((x - self.loc) / self.scale)

    def quantile(self, q):
        return self.loc + self.scale * (torch.log(q) - torch.log1p(-q))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.loc + self.scale * R.logistic(generator, shape, self.loc)


@dataclass(frozen=True)
class Gumbel(LeafDistribution):
    loc: object = 0.0
    scale: object = 1.0

    _params = ("loc", "scale")

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    def cdf(self, x):
        return torch.exp(-torch.exp(-(x - self.loc) / self.scale))

    def quantile(self, q):
        return self.loc - self.scale * torch.log(-torch.log(q))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.loc + self.scale * R.gumbel(generator, shape, self.loc)


@dataclass(frozen=True)
class SkewNormal(LeafDistribution):
    """Azzalini's skew normal. Its density holds log_ndtr(shape * z), which
    no fused form serves: a model with it takes the composed path."""

    loc: object = 0.0
    scale: object = 1.0
    shape_: object = 0.0

    _params = ("loc", "scale", "shape_")

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return (LOG2 - 0.5 * (z * z + LOG2PI) + torch.special.log_ndtr(self.shape_ * z)
                - torch.log(self.scale))

    def sample(self, generator, sample_shape=()):
        """Azzalini's representation: delta |Z0| + sqrt(1 - delta^2) Z1."""
        shape = tuple(sample_shape) + self.batch_shape
        delta = self.shape_ / torch.sqrt(1.0 + self.shape_ * self.shape_)
        z0 = torch.abs(R.normal(generator, shape, self.loc))
        z1 = R.normal(generator, shape, self.loc)
        return self.loc + self.scale * (delta * z0 + torch.sqrt(1.0 - delta * delta) * z1)


# ---------------------------------------------------------------------------
# positive half-line (log link, telescoped hooks)
# ---------------------------------------------------------------------------


class _Positive(LeafDistribution):
    """A family on (0, inf) whose linked density under the log link is the
    closed form `_linked(y)` of v = log x."""

    def _linked(self, y):
        raise NotImplementedError

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        if not _is_log_link(bijector):
            return None
        return (torch.exp(y) if want_x else None), self._linked(y)

    @property
    def support(self):
        return positive()


@dataclass(frozen=True)
class LogNormal(_Positive):
    mu: object = 0.0
    sigma: object = 1.0

    _params = ("mu", "sigma")

    def logpdf(self, x):
        lx = torch.log(x)
        z = (lx - self.mu) / self.sigma
        return -0.5 * (z * z + LOG2PI) - torch.log(self.sigma) - lx

    def cdf(self, x):
        return torch.special.ndtr((torch.log(x) - self.mu) / self.sigma)

    def quantile(self, q):
        return torch.exp(self.mu + self.sigma * torch.special.ndtri(q))

    def _linked(self, y):
        """logpdf(exp(v)) + v is the Normal density of v."""
        z = (y - self.mu) / self.sigma
        return -0.5 * (z * z + LOG2PI) - torch.log(self.sigma)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.exp(self.mu + self.sigma * R.normal(generator, shape, self.mu))


@dataclass(frozen=True)
class Exponential(_Positive):
    rate: object = 1.0

    _params = ("rate",)

    def logpdf(self, x):
        return torch.log(self.rate) - self.rate * x

    def cdf(self, x):
        return -torch.expm1(-self.rate * x)

    def quantile(self, q):
        return -torch.log1p(-q) / self.rate

    def _linked(self, y):
        """log r + v - r e^v: -inf, never NaN, where e^v overflows."""
        r = self.rate
        return torch.log(r) + y - r * torch.exp(y)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return R.exponential(generator, shape, self.rate) / self.rate


@dataclass(frozen=True)
class Gamma(_Positive):
    concentration: object = 1.0
    rate: object = 1.0

    _params = ("concentration", "rate")
    _cdf_fd = ("concentration",)  # gammainc has no derivative in a

    def logpdf(self, x):
        a, r = self.concentration, self.rate
        return a * torch.log(r) + (a - 1.0) * torch.log(x) - r * x - torch.lgamma(a)

    def cdf(self, x):
        return torch.special.gammainc(self.concentration, self.rate * x)

    def _linked(self, y):
        """a log r + a v - r e^v - lgamma(a)."""
        a, r = self.concentration, self.rate
        return a * torch.log(r) + a * y - r * torch.exp(y) - torch.lgamma(a)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return R.gamma(generator, self.concentration, shape) / self.rate


@dataclass(frozen=True)
class InverseGamma(_Positive):
    concentration: object = 1.0
    scale: object = 1.0

    _params = ("concentration", "scale")
    _cdf_fd = ("concentration",)  # gammaincc has no derivative in a

    def logpdf(self, x):
        a, b = self.concentration, self.scale
        return a * torch.log(b) - (a + 1.0) * torch.log(x) - b / x - torch.lgamma(a)

    def cdf(self, x):
        xs = torch.clamp_min(x, torch.finfo(x.dtype).tiny)
        c = torch.special.gammaincc(self.concentration, self.scale / xs)
        return torch.where(x > 0, c, torch.zeros_like(c))

    def _linked(self, y):
        """a log b - a v - b e^-v - lgamma(a)."""
        a, b = self.concentration, self.scale
        return a * torch.log(b) - a * y - b * torch.exp(-y) - torch.lgamma(a)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.scale / R.gamma(generator, self.concentration, shape)


@dataclass(frozen=True)
class Chi(_Positive):
    df: object = 1.0

    _params = ("df",)
    _cdf_fd = ("df",)  # gammainc has no derivative in a

    def logpdf(self, x):
        k2 = 0.5 * self.df
        return (2.0 * k2 - 1.0) * torch.log(x) - 0.5 * x * x - (k2 - 1.0) * LOG2 - torch.lgamma(k2)

    def cdf(self, x):
        xc = torch.clamp_min(x, 0.0)
        return torch.special.gammainc(0.5 * self.df, 0.5 * xc * xc)

    def _linked(self, y):
        """df v - e^(2v) / 2 - (df/2 - 1) log 2 - lgamma(df/2)."""
        df = self.df
        k2 = 0.5 * df
        return df * y - 0.5 * torch.exp(2.0 * y) - (k2 - 1.0) * LOG2 - torch.lgamma(k2)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.sqrt(2.0 * R.gamma(generator, 0.5 * self.df, shape))


@dataclass(frozen=True)
class Weibull(_Positive):
    concentration: object = 1.0  # shape k
    scale: object = 1.0

    _params = ("concentration", "scale")

    def logpdf(self, x):
        k, lam = self.concentration, self.scale
        z = x / lam
        return torch.log(k / lam) + (k - 1.0) * torch.log(z) - z**k

    def cdf(self, x):
        return -torch.expm1(-((x / self.scale) ** self.concentration))

    def quantile(self, q):
        return self.scale * (-torch.log1p(-q)) ** (1.0 / self.concentration)

    def _linked(self, y):
        """log k - k log lam + k v - e^(k v - k log lam)."""
        k = self.concentration
        c1 = k * torch.log(self.scale)
        return torch.log(k) - c1 + k * y - torch.exp(k * y - c1)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.scale * (-torch.log(R.uniform(generator, shape, self.scale, tiny=True))) ** (
            1.0 / self.concentration)


@dataclass(frozen=True)
class Rayleigh(_Positive):
    scale: object = 1.0

    _params = ("scale",)

    def logpdf(self, x):
        s2 = self.scale**2
        return torch.log(x) - torch.log(s2) - 0.5 * x * x / s2

    def cdf(self, x):
        return -torch.expm1(-0.5 * (torch.clamp_min(x, 0.0) / self.scale) ** 2)

    def quantile(self, q):
        return self.scale * torch.sqrt(-2.0 * torch.log1p(-q))

    def _linked(self, y):
        """2v - 2 log s - e^(2(v - log s)) / 2."""
        ls = torch.log(self.scale)
        return 2.0 * y - 2.0 * ls - 0.5 * torch.exp(2.0 * (y - ls))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.scale * torch.sqrt(-2.0 * torch.log(R.uniform(generator, shape, self.scale, tiny=True)))


@dataclass(frozen=True)
class Frechet(_Positive):
    shape_: object = 1.0
    scale: object = 1.0

    _params = ("shape_", "scale")

    def logpdf(self, x):
        a, s = self.shape_, self.scale
        z = x / s
        return torch.log(a / s) - (1.0 + a) * torch.log(z) - z ** (-a)

    def cdf(self, x):
        xs = torch.clamp_min(x, torch.finfo(x.dtype).tiny)
        c = torch.exp(-((xs / self.scale) ** -self.shape_))
        return torch.where(x > 0, c, torch.zeros_like(c))

    def quantile(self, q):
        return self.scale * (-torch.log(q)) ** (-1.0 / self.shape_)

    def _linked(self, y):
        """With w = v - log s: log a - a w - e^(-a w), a Gumbel form."""
        a = self.shape_
        w = y - torch.log(self.scale)
        return torch.log(a) - a * w - torch.exp(-a * w)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.scale * (-torch.log(R.uniform(generator, shape, self.scale, tiny=True))) ** (
            -1.0 / self.shape_)


@dataclass(frozen=True)
class HalfNormal(_Positive):
    scale: object = 1.0

    _params = ("scale",)

    def logpdf(self, x):
        z = x / self.scale
        return LOG2 - 0.5 * (z * z + LOG2PI) - torch.log(self.scale)

    def cdf(self, x):
        return torch.special.erf(torch.clamp_min(x, 0.0) / (self.scale * math.sqrt(2.0)))

    def quantile(self, q):
        return self.scale * math.sqrt(2.0) * torch.special.erfinv(q)

    def _linked(self, y):
        """const + v - e^(2(v - log s)) / 2."""
        ls = torch.log(self.scale)
        return (LOG2 - 0.5 * LOG2PI) - ls + y - 0.5 * torch.exp(2.0 * (y - ls))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.abs(self.scale * R.normal(generator, shape, self.scale))


@dataclass(frozen=True)
class HalfCauchy(_Positive):
    scale: object = 1.0

    _params = ("scale",)

    def logpdf(self, x):
        z = x / self.scale
        return LOG2 - LOGPI - torch.log(self.scale) - torch.log1p(z * z)

    def cdf(self, x):
        return (2.0 / math.pi) * torch.atan(torch.clamp_min(x, 0.0) / self.scale)

    def quantile(self, q):
        return self.scale * torch.tan(0.5 * math.pi * q)

    def _linked(self, y):
        """log1p(z^2) with z = e^(v - log s) is softplus(2(v - log s))."""
        ls = torch.log(self.scale)
        return (LOG2 - LOGPI) - ls + y - log1pexp(2.0 * (y - ls))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.abs(self.scale * R.cauchy(generator, shape, self.scale))


# ---------------------------------------------------------------------------
# bounded intervals (logit link, telescoped hooks)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Beta(LeafDistribution):
    a: object = 1.0
    b: object = 1.0

    _params = ("a", "b")
    _cdf_fd = ("a", "b")  # betainc has no derivative in a or b

    def _lbeta(self):
        return torch.lgamma(self.a) + torch.lgamma(self.b) - torch.lgamma(self.a + self.b)

    def logpdf(self, x):
        return (self.a - 1.0) * torch.log(x) + (self.b - 1.0) * torch.log1p(-x) - self._lbeta()

    def cdf(self, x):
        return betainc(self.a, self.b, clamp(x, 0.0, 1.0))

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """With the unit-interval logit link the linked density is
        -a softplus(-v) - b softplus(v) - log B(a, b)."""
        if not _is_interval_logit_link(bijector, 0.0, 1.0):
            return None
        lp = -self.a * log1pexp(-y) - self.b * log1pexp(y) - self._lbeta()
        return (torch.sigmoid(y) if want_x else None), lp

    @property
    def support(self):
        return unit_interval()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return R.beta(generator, self.a, self.b, shape)


@dataclass(frozen=True)
class LogitNormal(LeafDistribution):
    mu: object = 0.0
    sigma: object = 1.0

    _params = ("mu", "sigma")

    def logpdf(self, x):
        lx = torch.log(x) - torch.log1p(-x)
        z = (lx - self.mu) / self.sigma
        return (-0.5 * (z * z + LOG2PI) - torch.log(self.sigma) - torch.log(x)
                - torch.log1p(-x))

    def cdf(self, x):
        fi = torch.finfo(x.dtype)
        xc = clamp(x, fi.tiny, 1.0 - fi.eps / 2)  # 1 - epsneg
        return torch.special.ndtr((torch.log(xc) - torch.log1p(-xc) - self.mu) / self.sigma)

    def quantile(self, q):
        return torch.sigmoid(self.mu + self.sigma * torch.special.ndtri(q))

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """With the unit-interval logit link the density's -log x - log(1-x)
        cancels the link's log-det: the Normal density of v."""
        if not _is_interval_logit_link(bijector, 0.0, 1.0):
            return None
        z = (y - self.mu) / self.sigma
        lp = -0.5 * (z * z + LOG2PI) - torch.log(self.sigma)
        return (torch.sigmoid(y) if want_x else None), lp

    @property
    def support(self):
        return unit_interval()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.sigmoid(self.mu + self.sigma * R.normal(generator, shape, self.mu))


@dataclass(frozen=True)
class Uniform(LeafDistribution):
    low: object = 0.0
    high: object = 1.0

    _params = ("low", "high")

    def logpdf(self, x):
        lo, hi = self.low, self.high
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, -torch.log(hi - lo), torch.full_like(x, -math.inf))

    def cdf(self, x):
        return clamp((x - self.low) / (self.high - self.low), 0.0, 1.0)

    def quantile(self, q):
        return self.low + (self.high - self.low) * q

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """The width log(hi - lo) of the link's log-det cancels the density:
        -|v| - 2 softplus(-|v|), parameter-free."""
        if not _is_interval_logit_link(bijector, self.low, self.high):
            return None
        ay = torch.abs(y)
        lp = -ay - 2.0 * log1pexp(-ay)
        if not want_x:
            return None, lp
        return (self.high - self.low) * torch.sigmoid(y) + self.low, lp

    @property
    def support(self):
        return interval(_static_bound(self.low, "Uniform", "low"),
                        _static_bound(self.high, "Uniform", "high"))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.low + (self.high - self.low) * R.uniform(generator, shape, self.low)


# ---------------------------------------------------------------------------
# lower-bounded (shifted-log link, telescoped hooks)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Pareto(LeafDistribution):
    """Pareto(shape alpha, scale x_m) on [x_m, inf)."""

    alpha: object = 1.0
    scale: object = 1.0

    _params = ("alpha", "scale")

    def logpdf(self, x):
        a = self.alpha
        return torch.log(a) + a * torch.log(self.scale) - (a + 1.0) * torch.log(x)

    def cdf(self, x):
        xs = torch.maximum(x, self.scale)
        return -torch.expm1(-self.alpha * torch.log(xs / self.scale))

    def quantile(self, q):
        return self.scale * torch.exp(-torch.log1p(-q) / self.alpha)

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """y = log(x - x_m), so log x = logaddexp(log x_m, v)."""
        if not _is_shifted_log_link(bijector, self.scale):
            return None
        a = self.alpha
        lm = torch.log(self.scale)
        lp = torch.log(a) + a * lm + y - (a + 1.0) * torch.logaddexp(lm, y)
        return (self.scale + torch.exp(y) if want_x else None), lp

    @property
    def support(self):
        return lower_bounded(_static_bound(self.scale, "Pareto", "scale"))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.scale * R.uniform(generator, shape, self.scale, tiny=True) ** (-1.0 / self.alpha)


@dataclass(frozen=True)
class Levy(LeafDistribution):
    """Levy(mu, sigma) on [mu, inf)."""

    mu: object = 0.0
    sigma: object = 1.0

    _params = ("mu", "sigma")

    def logpdf(self, x):
        s = self.sigma
        d = x - self.mu
        return 0.5 * (torch.log(s) - LOG2PI) - 0.5 * s / d - 1.5 * torch.log(d)

    def cdf(self, x):
        d = torch.clamp_min(x - self.mu, torch.finfo(x.dtype).tiny)
        c = torch.special.erfc(torch.sqrt(0.5 * self.sigma / d))
        return torch.where(x > self.mu, c, torch.zeros_like(c))

    def quantile(self, q):
        # cdf = erfc(sqrt(s / 2d)) = q  =>  d = s / ndtri(q / 2)^2
        z = torch.special.ndtri(0.5 * q)
        return self.mu + self.sigma / (z * z)

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """y = log(x - mu): 0.5 (log s - log 2pi) - s e^-v / 2 - v / 2."""
        if not _is_shifted_log_link(bijector, self.mu):
            return None
        s = self.sigma
        lp = 0.5 * (torch.log(s) - LOG2PI) - 0.5 * s * torch.exp(-y) - 0.5 * y
        return (self.mu + torch.exp(y) if want_x else None), lp

    @property
    def support(self):
        return lower_bounded(_static_bound(self.mu, "Levy", "mu"))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        z = R.normal(generator, shape, self.mu)
        return self.mu + self.sigma / (z * z)


# ---------------------------------------------------------------------------
# no slab form (the traced entries of the fused evaluation serve them)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Kumaraswamy(LeafDistribution):
    a: object = 1.0
    b: object = 1.0

    _params = ("a", "b")

    def logpdf(self, x):
        a, b = self.a, self.b
        return (torch.log(a) + torch.log(b) + (a - 1.0) * torch.log(x)
                + (b - 1.0) * torch.log1p(-(x**a)))

    def cdf(self, x):
        return -torch.expm1(self.b * torch.log1p(-(x**self.a)))

    def quantile(self, q):
        return (-torch.expm1(torch.log1p(-q) / self.b)) ** (1.0 / self.a)

    @property
    def support(self):
        return unit_interval()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return (1.0 - R.uniform(generator, shape, self.a, tiny=True) ** (1.0 / self.b)) ** (1.0 / self.a)


@dataclass(frozen=True)
class Arcsine(LeafDistribution):
    """The arcsine distribution on (a, b)."""

    a: object = 0.0
    b: object = 1.0

    _params = ("a", "b")

    def logpdf(self, x):
        return -(LOGPI + 0.5 * (torch.log(x - self.a) + torch.log(self.b - x)))

    def cdf(self, x):
        z = clamp((x - self.a) / (self.b - self.a), 0.0, 1.0)
        return (2.0 / math.pi) * torch.asin(torch.sqrt(z))

    def quantile(self, q):
        s = torch.sin(0.5 * math.pi * q)
        return self.a + (self.b - self.a) * s * s

    @property
    def support(self):
        return interval(_static_bound(self.a, "Arcsine", "a"),
                        _static_bound(self.b, "Arcsine", "b"))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        s = torch.sin(0.5 * math.pi * R.uniform(generator, shape, self.a))
        return self.a + (self.b - self.a) * s * s


@dataclass(frozen=True)
class Truncated(Distribution):
    """truncated(base; lower, upper) with static bounds (reference
    Distributions.truncated): logpdf renormalises the base's by
    cdf(upper) - cdf(lower) and is -inf outside [lower, upper]."""

    base: Distribution
    lower: float = -math.inf
    upper: float = math.inf

    def __post_init__(self):
        object.__setattr__(self, "lower", float(self.lower))
        object.__setattr__(self, "upper", float(self.upper))

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def _bound_cdf(self, bound, like, outside):
        if not math.isfinite(bound):
            return outside
        return self.base.cdf(torch.as_tensor(bound, dtype=like.dtype, device=like.device))

    def logpdf(self, x):
        lo_c = self._bound_cdf(self.lower, x, 0.0)
        hi_c = self._bound_cdf(self.upper, x, 1.0)
        lp = self.base.logpdf(x) - torch.log(hi_c - lo_c)
        inside = torch.ones_like(lp, dtype=torch.bool)
        if math.isfinite(self.lower):
            inside = inside & (x >= self.lower)
        if math.isfinite(self.upper):
            inside = inside & (x <= self.upper)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def cdf(self, x):
        lo_c = self._bound_cdf(self.lower, x, 0.0)
        hi_c = self._bound_cdf(self.upper, x, 1.0)
        xc = torch.clamp(x, self.lower, self.upper)
        return (self.base.cdf(xc) - lo_c) / (hi_c - lo_c)

    @property
    def support(self):
        bs = self.base.support
        lo, hi = max(self.lower, bs.lower), min(self.upper, bs.upper)
        return Support("interval", lo, hi, math.isfinite(lo), math.isfinite(hi))

    def to(self, device):
        return Truncated(self.base.to(device), self.lower, self.upper)

    def sample(self, generator, sample_shape=()):
        """The base's quantile at cdf(lower) + (cdf(upper) - cdf(lower)) u:
        its closed form, or the generic solve on its cdf."""
        like = first_param(self.base)
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        lo_c = self._bound_cdf(self.lower, like, 0.0)
        hi_c = self._bound_cdf(self.upper, like, 1.0)
        q = lo_c + (hi_c - lo_c) * R.uniform(generator, shape, like)
        return self.base.quantile(q)


@dataclass(frozen=True)
class Chisq(LeafDistribution):
    """Chi-squared(df) (log link; no slab form: the traced entries serve it)."""

    df: object = 1.0

    _params = ("df",)
    _cdf_fd = ("df",)  # gammainc has no derivative in a

    def logpdf(self, x):
        k2 = 0.5 * self.df
        return (k2 - 1.0) * torch.log(x) - 0.5 * x - k2 * LOG2 - torch.lgamma(k2)

    def cdf(self, x):
        return torch.special.gammainc(0.5 * self.df, 0.5 * torch.clamp_min(x, 0.0))

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return 2.0 * R.gamma(generator, 0.5 * self.df, shape)


# ---------------------------------------------------------------------------
# discrete (the registry's Identity link, reference
# src/transformed_distribution.jl:75-76): the pmf's log, its draws as
# int64 counts, its cdf
# ---------------------------------------------------------------------------


def _fx(x, like):
    """x (a count, perhaps an integer tensor) in the parameters' dtype."""
    return torch.as_tensor(x, device=like.device).to(like.dtype)


@dataclass(frozen=True)
class Poisson(DiscreteDistribution):
    rate: object = 1.0

    _params = ("rate",)

    def logpdf(self, x):
        x, r = _fx(x, self.rate), self.rate
        return x * torch.log(r) - r - torch.lgamma(x + 1.0)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return R.poisson(generator, self.rate, shape).long()

    def cdf(self, x):
        k = torch.floor(_fx(x, self.rate))
        c = torch.special.gammaincc(torch.clamp_min(k, 0.0) + 1.0, self.rate)
        return torch.where(k >= 0, c, torch.zeros_like(c))


@dataclass(frozen=True)
class Bernoulli(DiscreteDistribution):
    p: object = 0.5

    _params = ("p",)

    def logpdf(self, x):
        x, p = _fx(x, self.p), self.p
        return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return R.bernoulli(generator, self.p, shape).long()

    def cdf(self, x):
        x, p = _fx(x, self.p), self.p
        return torch.where(x < 0, 0.0, torch.where(x < 1, 1.0 - p, 1.0))


@dataclass(frozen=True)
class Binomial(DiscreteDistribution):
    n: int = 1
    p: object = 0.5

    _params = ("p",)

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "n", int(self.n))
        super().__post_init__(device, dtype)

    def logpdf(self, x):
        x, p, n = _fx(x, self.p), self.p, float(self.n)
        logc = math.lgamma(n + 1.0) - torch.lgamma(x + 1.0) - torch.lgamma(n - x + 1.0)
        return logc + x * torch.log(p) + (n - x) * torch.log1p(-p)

    def sample(self, generator, sample_shape=()):
        """The sum of n Bernoulli(p) draws, as the JAX sampler's."""
        shape = tuple(sample_shape) + self.batch_shape
        return R.bernoulli(generator, self.p, (self.n,) + shape).sum(0).long()

    def cdf(self, x):
        p = self.p
        k = torch.floor(_fx(x, p))
        kc = torch.clamp(k, 0.0, self.n - 1.0)
        val = betainc(self.n - kc, kc + 1.0, 1.0 - p)
        return torch.where(k < 0, 0.0, torch.where(k >= self.n, 1.0, val))


@dataclass(frozen=True)
class Geometric(DiscreteDistribution):
    """The number of failures before the first success."""

    p: object = 0.5

    _params = ("p",)

    def logpdf(self, x):
        x, p = _fx(x, self.p), self.p
        return x * torch.log1p(-p) + torch.log(p)

    def sample(self, generator, sample_shape=()):
        """floor(log u / log(1 - p)), u in (0, 1]: the failures of the JAX
        sampler's trial count."""
        shape = tuple(sample_shape) + self.batch_shape
        u = 1.0 - R.uniform(generator, shape, self.p)
        return torch.floor(torch.log(u) / torch.log1p(-self.p)).long()

    def cdf(self, x):
        p = self.p
        k = torch.floor(_fx(x, p))
        c = -torch.expm1(torch.log1p(-p) * (torch.clamp_min(k, 0.0) + 1.0))
        return torch.where(k >= 0, c, torch.zeros_like(c))


@dataclass(frozen=True)
class Categorical(DiscreteDistribution):
    """Categories 0 .. K-1 with probabilities softmax(logits)."""

    logits: object = None

    _params = ("logits",)

    @property
    def batch_shape(self):
        return tuple(self.logits.shape[:-1])

    def logpdf(self, x):
        logp = torch.log_softmax(self.logits, -1)
        idx = torch.as_tensor(x, device=logp.device).long()[..., None]
        shape = torch.broadcast_shapes(idx.shape[:-1], logp.shape[:-1])
        return torch.take_along_dim(logp.expand(shape + logp.shape[-1:]),
                                    idx.expand(shape + (1,)), dim=-1)[..., 0]

    def sample(self, generator, sample_shape=()):
        return R.categorical(generator, self.logits, tuple(sample_shape))

    def cdf(self, x):
        p = torch.softmax(self.logits, -1)
        k = torch.floor(_fx(x, p))
        idx = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
        return torch.sum(torch.where(idx <= k[..., None], p, 0.0), -1)
