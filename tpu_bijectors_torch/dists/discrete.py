"""Discrete families, part 2, PyTorch counterpart of
`tpu_bijectors/dists/discrete.py`: BernoulliLogit, BetaBinomial, Dirac,
DiscreteUniform, DiscreteNonParametric, Hypergeometric, PoissonBinomial,
Skellam and Soliton. Every one takes the Identity link (reference
src/transformed_distribution.jl:75-76); `logpdf` is the pmf's log, plain
torch on either device as the JAX package computes it in jnp, and draws
are int64 counts (Dirac's and DiscreteNonParametric's, the values
themselves).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import _random as R
from .base import DiscreteDistribution
from .univariate import _fx
from .univariate3 import _windowed_series_logsumexp

_N_BESSEL = 96  # the terms of log I_k's series

def _log_binom(n, k):
    return torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


@dataclass(frozen=True)
class BernoulliLogit(DiscreteDistribution):
    logitp: object = 0.0

    _params = ("logitp",)

    def logpdf(self, x):
        # x l - softplus(l): log sigmoid(l) at 1, log sigmoid(-l) at 0
        l_ = self.logitp
        return _fx(x, l_) * l_ - torch.nn.functional.softplus(l_)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return R.bernoulli(generator, torch.sigmoid(self.logitp), shape).long()

    def cdf(self, x):
        p = torch.sigmoid(self.logitp)
        x = _fx(x, p)
        return torch.where(x < 0, 0.0, torch.where(x < 1, 1.0 - p, 1.0))


@dataclass(frozen=True)
class BetaBinomial(DiscreteDistribution):
    n: int = 1
    a: object = 1.0
    b: object = 1.0

    _params = ("a", "b")

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "n", int(self.n))
        super().__post_init__(device, dtype)

    def logpdf(self, x):
        a, b = self.a, self.b
        x = _fx(x, a)
        n = float(self.n)
        valid = (x >= 0) & (x <= n)
        xc = torch.clamp(x, 0.0, n)  # no -inf + inf outside the support
        nt = torch.as_tensor(n, dtype=a.dtype, device=a.device)
        lp = _log_binom(nt, xc) + _lbeta(xc + a, n - xc + b) - _lbeta(a, b)
        return torch.where(valid, lp, -math.inf)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        p = R.beta(generator, self.a, self.b, shape)
        return R.binomial(generator, torch.full_like(p, float(self.n)), p, shape).long()

    def cdf(self, x):
        """sum_{j <= k} pmf(j) over the n + 1 points."""
        ks = torch.arange(self.n + 1, dtype=self.a.dtype, device=self.a.device)
        pmf = torch.exp(self.logpdf(ks))
        k = torch.floor(_fx(x, self.a))
        return torch.sum(torch.where(ks <= k[..., None], pmf, 0.0), -1)


@dataclass(frozen=True)
class Dirac(DiscreteDistribution):
    """The point mass at `value` (logpdf 0 there, -inf elsewhere)."""

    value: object = 0.0

    _params = ("value",)

    def logpdf(self, x):
        return torch.where(_fx(x, self.value) == self.value, 0.0, -math.inf).to(self.value.dtype)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return torch.broadcast_to(self.value, shape)

    def cdf(self, x):
        return torch.where(_fx(x, self.value) >= self.value, 1.0, 0.0).to(self.value.dtype)


@dataclass(frozen=True)
class DiscreteUniform(DiscreteDistribution):
    """The integers a .. b, each with probability 1 / (b - a + 1)."""

    a: int = 0
    b: int = 1

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "a", int(self.a))
        object.__setattr__(self, "b", int(self.b))
        super().__post_init__(device, dtype)

    def logpdf(self, x):
        x = _fx(x, self._like)
        inside = (x >= self.a) & (x <= self.b)
        lp = torch.full_like(x, -math.log(self.b - self.a + 1))
        return torch.where(inside, lp, -math.inf)

    def sample(self, generator, sample_shape=()):
        return torch.randint(self.a, self.b + 1, tuple(sample_shape), generator=generator,
                             device=self._like.device)

    def cdf(self, x):
        k = torch.floor(_fx(x, self._like))
        return torch.clamp((k - self.a + 1.0) / (self.b - self.a + 1.0), 0.0, 1.0)


@dataclass(frozen=True)
class DiscreteNonParametric(DiscreteDistribution):
    """A finite support: the values xs with probabilities ps."""

    xs: object = None
    ps: object = None

    _params = ("xs", "ps")

    @property
    def batch_shape(self):
        return tuple(self.ps.shape[:-1])

    def logpdf(self, x):
        x = _fx(x, self.ps)
        match = x[..., None] == self.xs
        p = torch.sum(torch.where(match, self.ps, 0.0), -1)
        tiny = torch.finfo(p.dtype).tiny
        return torch.log(torch.clamp_min(p, tiny)) + torch.where(
            torch.any(match, -1), 0.0, -math.inf).to(p.dtype)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        idx = R.categorical(generator, torch.log(self.ps), shape)
        return self.xs[idx]

    def cdf(self, x):
        x = _fx(x, self.ps)
        return torch.sum(torch.where(self.xs <= x[..., None], self.ps, 0.0), -1)


@dataclass(frozen=True)
class Hypergeometric(DiscreteDistribution):
    """Successes in n draws without replacement from ns successes and nf
    failures."""

    ns: int = 1
    nf: int = 1
    n: int = 1

    def __post_init__(self, device, dtype):
        for k in ("ns", "nf", "n"):
            object.__setattr__(self, k, int(getattr(self, k)))
        super().__post_init__(device, dtype)

    def logpdf(self, x):
        x = _fx(x, self._like)
        c = lambda v: torch.as_tensor(float(v), dtype=x.dtype, device=x.device)  # noqa: E731
        return (_log_binom(c(self.ns), x) + _log_binom(c(self.nf), self.n - x)
                - _log_binom(c(self.ns + self.nf), c(self.n)))

    def sample(self, generator, sample_shape=()):
        """The successes among the n items of largest uniform key (a draw
        without replacement)."""
        shape = tuple(sample_shape)
        g = R.uniform(generator, shape + (self.ns + self.nf,), self._like)
        idx = torch.topk(g, self.n, -1).indices
        return torch.sum(idx < self.ns, -1)


@dataclass(frozen=True)
class PoissonBinomial(DiscreteDistribution):
    """The sum of independent Bernoulli(ps_i): the pmf by the convolution
    over the ps, one step a probability."""

    ps: object = None

    _params = ("ps",)

    @property
    def batch_shape(self):
        return ()

    def _pmf_vector(self):
        ps = self.ps
        n = ps.shape[-1]
        pmf = torch.zeros(n + 1, dtype=ps.dtype, device=ps.device)
        pmf = torch.cat([torch.ones_like(pmf[:1]), pmf[1:]])
        for i in range(n):
            shifted = torch.cat([torch.zeros_like(pmf[:1]), pmf[:-1]])
            pmf = pmf * (1.0 - ps[i]) + shifted * ps[i]
        return pmf

    def logpdf(self, x):
        pmf = self._pmf_vector()
        xf = _fx(x, pmf)
        xi = torch.clamp(xf.long(), 0, pmf.shape[0] - 1)
        p = pmf[xi]
        valid = (xf >= 0) & (xf <= pmf.shape[0] - 1)
        tiny = torch.finfo(p.dtype).tiny
        return torch.where(valid, torch.log(torch.clamp_min(p, tiny)), -math.inf)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape)
        u = R.uniform(generator, shape + (self.ps.shape[-1],), self.ps)
        return torch.sum(u < self.ps, -1)


def _log_bessel_i(order, z):
    """log I_order(z) for integer order >= 0: the ascending series
    sum_m (z/2)^(2m + order) / (m! (m + order)!) over a window of 96 terms
    centred on the dominant one (`_windowed_series_logsumexp`)."""
    log_half_z = torch.log(torch.clamp_min(0.5 * z, torch.finfo(z.dtype).tiny))

    def lt(m):
        return ((2.0 * m + order[..., None]) * log_half_z[..., None] - torch.lgamma(m + 1.0)
                - torch.lgamma(m + order[..., None] + 1.0))

    return _windowed_series_logsumexp(lt, z, n=_N_BESSEL)


@dataclass(frozen=True)
class Skellam(DiscreteDistribution):
    """The difference of two independent Poissons: pmf(k) =
    e^-(m1 + m2) (m1 / m2)^(k/2) I_|k|(2 sqrt(m1 m2))."""

    mu1: object = 1.0
    mu2: object = 1.0

    _params = ("mu1", "mu2")

    def logpdf(self, x):
        m1, m2 = self.mu1, self.mu2
        k = _fx(x, m1)
        z = 2.0 * torch.sqrt(m1 * m2)
        return (-(m1 + m2) + 0.5 * k * (torch.log(m1) - torch.log(m2))
                + _log_bessel_i(torch.abs(k), torch.broadcast_to(z, k.shape)))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        n1 = R.poisson(generator, self.mu1, shape)
        n2 = R.poisson(generator, self.mu2, shape)
        return (n1 - n2).long()


@dataclass(frozen=True)
class Soliton(DiscreteDistribution):
    """The robust soliton distribution on 1 .. K with its spike at M (LT
    codes; Distributions.jl's Soliton(K, M, delta)): rho(1) = 1/K,
    rho(i) = 1/(i(i-1)); tau(i) = 1/(iM) below M, log(K / (M delta)) / M
    at M, else 0; pmf = (rho + tau) / their sum."""

    K: int = 10
    M: int = 5
    delta: float = 0.1

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "K", int(self.K))
        object.__setattr__(self, "M", int(self.M))
        object.__setattr__(self, "delta", float(self.delta))
        super().__post_init__(device, dtype)

    def _pmf(self):
        i = np.arange(1, self.K + 1, dtype=np.float64)
        rho = np.where(i == 1, 1.0 / self.K, 1.0 / (i * np.maximum(i - 1.0, 1.0)))
        R_ = self.K / self.M
        tau = np.where(i < self.M, 1.0 / (i * self.M),
                       np.where(i == self.M, math.log(R_ / self.delta) / self.M, 0.0))
        p = rho + tau
        return p / p.sum()

    def logpdf(self, x):
        x = _fx(x, self._like)
        pmf = torch.as_tensor(self._pmf(), dtype=x.dtype, device=x.device)
        xi = torch.clamp(x.long() - 1, 0, self.K - 1)
        valid = (x >= 1) & (x <= self.K)
        return torch.where(valid, torch.log(pmf[xi]), -math.inf)

    def sample(self, generator, sample_shape=()):
        logp = torch.log(torch.as_tensor(self._pmf(), dtype=self._like.dtype,
                                         device=self._like.device))
        return R.categorical(generator, logp, tuple(sample_shape)) + 1
