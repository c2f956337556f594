"""Multivariate families, PyTorch counterpart of
`tpu_bijectors/dists/multivariate.py`: Dirichlet, the dense Gaussians
(MvNormalDiag, MvNormalTril, the `MvNormal` constructor, MvNormalCanon),
MvLogNormal, MvStudentT, MvLogitNormal (the simplex link) and the
discrete Multinomial (the Identity link).

The Gaussian and t families take the identity link (MvLogNormal the
elementwise log link). In the fused whole-model evaluation
(vectorize/fused_plan.py) MvNormalDiag and MvLogNormal are slab rows and
the dense ones loop entries of the whole-model kernels; their triangular
solves here are `torch.linalg.solve_triangular` and `torch.cholesky_solve`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..bijectors.base import Block, Identity
from ..bijectors.simplex import SimplexBijector, _simplex_inverse_logdet_wlog
from ..utils import cholesky_lower
from . import _random as R
from .base import REAL_VECTOR, SIMPLEX, DiscreteDistribution, LeafDistribution, positive
from .univariate import _fx, _is_log_link

LOG2PI = math.log(2.0 * math.pi)
LOGPI = math.log(math.pi)


@dataclass(frozen=True)
class Dirichlet(LeafDistribution):
    """Dirichlet(alpha); support = interior of the simplex."""

    alpha: object

    _params = ("alpha",)
    event_ndims = 1

    @property
    def event_shape(self):
        return (self.alpha.shape[-1],)

    def _lognorm(self):
        a = self.alpha
        return torch.sum(torch.lgamma(a), -1) - torch.lgamma(torch.sum(a, -1))

    def logpdf(self, x):
        return torch.sum((self.alpha - 1.0) * torch.log(x), -1) - self._lognorm()

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """Composed linked density with the reference's eps-nudged weighted
        log term (src/Bijectors.jl:253), finite at 1e10 jumps. Returns
        (x or None, logpdf + logdetJ), or None to decline. On the card the
        inverse, its log-det and the data term are one kernel launch."""
        if type(bijector) is not SimplexBijector or self.alpha.ndim != 1:
            return None
        x, ld, wlog = _simplex_inverse_logdet_wlog(y, self.alpha - 1.0, want_x)
        return x, wlog - self._lognorm() + ld

    @property
    def support(self):
        return SIMPLEX

    def sample(self, generator, sample_shape=()):
        """Normalised Gamma(alpha_k) draws."""
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        g = R.gamma(generator, self.alpha, shape)
        return g / torch.sum(g, -1, keepdim=True)


def _is_vector_link(b, scalar_test) -> bool:
    """True when `b` is a scalar link over one event dim whose scalar
    bijector passes `scalar_test`."""
    return type(b) is Block and b.ndims == 1 and scalar_test(b.bijector)


def _is_identity(b) -> bool:
    return type(b) is Identity


def _mvdiag_logpdf(loc, scale_diag, x):
    z = (x - loc) / scale_diag
    K = loc.shape[-1]
    sig = torch.broadcast_to(scale_diag, loc.shape)
    return -0.5 * torch.sum(z * z, -1) - 0.5 * K * LOG2PI - torch.sum(torch.log(sig), -1)


def _mvdiag_logpdf_t(loc, scale_diag, yT):
    """Diagonal-normal density of the transposed (K, B) state; None if loc
    is batched (the caller takes the broadcasting path)."""
    if loc.ndim != 1:
        return None
    K = loc.shape[-1]
    mu = loc.to(yT.dtype)[:, None]
    sig = torch.broadcast_to(scale_diag.to(yT.dtype), (K,))[:, None]
    z = (yT - mu) / sig
    return -0.5 * torch.sum(z * z, 0) - 0.5 * K * LOG2PI - torch.sum(torch.log(sig))


def _tril_solve(L, r):
    """z = L^-1 r for lower-triangular L (..., K, K) and r (..., K),
    broadcasting the leading axes."""
    Lb = torch.broadcast_to(L, r.shape[:-1] + L.shape[-2:])
    return torch.linalg.solve_triangular(Lb, r[..., None], upper=False)[..., 0]


def _half_logdet(L):
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)


@dataclass(frozen=True)
class MvNormalDiag(LeafDistribution):
    """Normal with mean `loc` (K,) and diagonal scale `scale_diag`."""

    loc: object
    scale_diag: object

    _params = ("loc", "scale_diag")
    event_ndims = 1

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    def logpdf(self, x):
        return _mvdiag_logpdf(self.loc, self.scale_diag, x)

    def fused_linked_logdensity_t(self, bijector, yT):
        """The identity link's linked density on the (K, B) block in place."""
        if not _is_vector_link(bijector, _is_identity):
            return None
        return _mvdiag_logpdf_t(self.loc, self.scale_diag, yT)

    @property
    def support(self):
        return REAL_VECTOR

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        return self.loc + self.scale_diag * R.normal(generator, shape, self.loc)


@dataclass(frozen=True)
class MvNormalTril(LeafDistribution):
    """Normal with mean `loc` and lower-triangular scale `scale_tril`
    (the Cholesky factor of the covariance)."""

    loc: object
    scale_tril: object

    _params = ("loc", "scale_tril")
    event_ndims = 1

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape[:-1], self.scale_tril.shape[:-2]))

    def logpdf(self, x):
        L = torch.tril(self.scale_tril)
        K = self.loc.shape[-1]
        z = _tril_solve(L, x - self.loc)
        return -0.5 * (torch.sum(z * z, -1) + K * LOG2PI) - _half_logdet(L)

    @property
    def support(self):
        return REAL_VECTOR

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = R.normal(generator, shape, self.loc)
        return self.loc + torch.einsum("...ij,...j->...i", torch.tril(self.scale_tril), eps)


def MvNormal(loc, cov=None, *, scale_tril=None, scale_diag=None, device=None, dtype=None):
    """The Distributions.jl arities: a `scale_tril` or a matrix `cov` gives
    MvNormalTril (cov through its Cholesky factor), a `scale_diag` or a
    vector `cov` MvNormalDiag, no scale the unit diagonal."""
    kw = dict(device=device, dtype=dtype)
    if scale_tril is not None:
        return MvNormalTril(loc, scale_tril, **kw)
    if scale_diag is not None:
        return MvNormalDiag(loc, scale_diag, **kw)
    if cov is None:
        return MvNormalDiag(loc, 1.0, **kw)
    cov = torch.as_tensor(cov)
    if cov.ndim >= 2:
        return MvNormalTril(loc, torch.linalg.cholesky(cov), **kw)
    return MvNormalDiag(loc, torch.sqrt(cov), **kw)


@dataclass(frozen=True)
class MvLogNormal(LeafDistribution):
    """exp() of an MvNormalDiag; the positive orthant, elementwise log link
    (reference src/vector/multivariate/mvlognormal.jl)."""

    loc: object
    scale_diag: object

    _params = ("loc", "scale_diag")
    event_ndims = 1

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    def logpdf(self, x):
        lx = torch.log(x)
        return _mvdiag_logpdf(self.loc, self.scale_diag, lx) - torch.sum(lx, -1)

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """Telescoped linked density: under the elementwise log link,
        logpdf(e^v) + sum v is the base MvNormalDiag density of v, finite at
        |v| ~ 1e10 where exp(v) over- or underflows."""
        if not _is_vector_link(bijector, _is_log_link):
            return None
        lp = _mvdiag_logpdf(self.loc, self.scale_diag, y)
        return (torch.exp(y) if want_x else None), lp

    def fused_linked_logdensity_t(self, bijector, yT):
        """The same on the (K, B) block in place."""
        if not _is_vector_link(bijector, _is_log_link):
            return None
        return _mvdiag_logpdf_t(self.loc, self.scale_diag, yT)

    @property
    def support(self):
        return positive()

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        return torch.exp(self.loc + self.scale_diag * R.normal(generator, shape, self.loc))


@dataclass(frozen=True)
class MvStudentT(LeafDistribution):
    """Multivariate t with `df` degrees of freedom, location `loc` and
    lower-triangular scale `scale_tril`; identity link (MvTDist in the
    reference registry)."""

    df: object
    loc: object
    scale_tril: object

    _params = ("df", "loc", "scale_tril")
    event_ndims = 1

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    @property
    def batch_shape(self):
        return tuple(self.loc.shape[:-1])

    def logpdf(self, x):
        K = self.loc.shape[-1]
        v = self.df
        L = torch.tril(self.scale_tril)
        z = _tril_solve(L, x - self.loc)
        q = torch.sum(z * z, -1)
        return (
            torch.lgamma(0.5 * (v + K))
            - torch.lgamma(0.5 * v)
            - 0.5 * K * (torch.log(v) + LOGPI)
            - _half_logdet(L)
            - 0.5 * (v + K) * torch.log1p(q / v)
        )

    @property
    def support(self):
        return REAL_VECTOR

    def sample(self, generator, sample_shape=()):
        """loc + sqrt(df / chi2(df)) L eps."""
        shape = tuple(sample_shape) + self.batch_shape
        eps = R.normal(generator, shape + self.event_shape, self.loc)
        g = R.gamma(generator, 0.5 * self.df, shape)
        w = torch.sqrt(0.5 * self.df / g)[..., None]
        return self.loc + w * torch.einsum("...ij,...j->...i", torch.tril(self.scale_tril), eps)


@dataclass(frozen=True)
class MvNormalCanon(LeafDistribution):
    """Canonical parametrisation: potential `h` (K,) and precision `prec`
    (K, K) SPD; the mean is prec^-1 h."""

    h: object
    prec: object

    _params = ("h", "prec")
    event_ndims = 1

    @property
    def event_shape(self):
        return (self.h.shape[-1],)

    @property
    def batch_shape(self):
        return tuple(self.h.shape[:-1])

    def chol_and_mean(self, dtype):
        """(L with prec = L L', the mean prec^-1 h), in `dtype`."""
        L = cholesky_lower(self.prec.to(dtype))
        mu = torch.cholesky_solve(self.h.to(dtype)[..., None], L)[..., 0]
        return L, mu

    def logpdf(self, x):
        K = self.h.shape[-1]
        L, mu = self.chol_and_mean(x.dtype)
        # r' J r = ||L' r||^2
        z = torch.einsum("...ji,...j->...i", L, x - mu)
        return -0.5 * (torch.sum(z * z, -1) + K * LOG2PI) + _half_logdet(L)

    @property
    def support(self):
        return REAL_VECTOR

    def sample(self, generator, sample_shape=()):
        """mu + L'^-1 eps, whose covariance is prec^-1 (prec = L L')."""
        L, mu = self.chol_and_mean(self.h.dtype)
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = R.normal(generator, shape, self.h)
        Lt = L.transpose(-1, -2).expand(shape[:-1] + L.shape[-2:])
        return mu + torch.linalg.solve_triangular(Lt, eps[..., None], upper=True)[..., 0]


@dataclass(frozen=True)
class MvLogitNormal(LeafDistribution):
    """softmax([y; 0]) of y ~ MvNormalTril(loc, scale_tril): the simplex
    support, its link the SimplexBijector (reference
    src/vector/multivariate/simplex.jl), whose kernels #7-#9 run it on the
    card."""

    loc: object
    scale_tril: object

    _params = ("loc", "scale_tril")
    event_ndims = 1

    @property
    def event_shape(self):
        return (self.loc.shape[-1] + 1,)

    @property
    def batch_shape(self):
        return tuple(self.loc.shape[:-1])

    def _base(self):
        return MvNormalTril(self.loc, self.scale_tril, device=self.loc.device)

    def logpdf(self, x):
        # y_i = log(x_i / x_K), i = 1 .. K-1
        y = torch.log(x[..., :-1]) - torch.log(x[..., -1:])
        return self._base().logpdf(y) - torch.sum(torch.log(x), -1)

    @property
    def support(self):
        return SIMPLEX

    def sample(self, generator, sample_shape=()):
        y = self._base().sample(generator, sample_shape)
        return torch.softmax(torch.cat([y, torch.zeros_like(y[..., :1])], -1), -1)


@dataclass(frozen=True)
class Multinomial(DiscreteDistribution):
    """Multinomial(n, p): counts over K categories summing to n (the
    Identity link, reference test/vector/multivariate.jl:2)."""

    n: int = 1
    p: object = None

    _params = ("p",)
    event_ndims = 1

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "n", int(self.n))
        super().__post_init__(device, dtype)

    @property
    def event_shape(self):
        return (self.p.shape[-1],)

    @property
    def batch_shape(self):
        return tuple(self.p.shape[:-1])

    def logpdf(self, x):
        p = self.p
        x = _fx(x, p)
        lp = (math.lgamma(self.n + 1.0) - torch.sum(torch.lgamma(x + 1.0), -1)
              + torch.sum(torch.xlogy(x, p), -1))  # 0 log 0 = 0 for an empty category
        return torch.where(torch.sum(x, -1) == self.n, lp, -math.inf)

    def sample(self, generator, sample_shape=()):
        """Sequential conditional binomials over the K categories."""
        K = int(self.p.shape[-1])
        shape = tuple(sample_shape) + self.batch_shape
        p = self.p
        rest = torch.flip(torch.cumsum(torch.flip(p, (-1,)), -1), (-1,))  # tail sums
        remaining = torch.full(shape, float(self.n), dtype=p.dtype, device=p.device)
        counts = []
        for k in range(K - 1):
            frac = torch.clamp(p[..., k] / torch.clamp_min(rest[..., k], 1e-30), 0.0, 1.0)
            c = R.binomial(generator, remaining, frac, shape)
            counts.append(c)
            remaining = remaining - c
        counts.append(remaining)
        return torch.stack(counts, -1).long()
