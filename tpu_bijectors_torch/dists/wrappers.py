"""Wrapper distributions, PyTorch counterpart of
`tpu_bijectors/dists/wrappers.py`: a finite Mixture of one batched scalar
family, the JointOrderStatistics of n iid draws (reference
src/vector/order/order.jl:14-76), Reshaped (src/vector/reshaped/),
Censored, the OrderStatistic of one rank, MatrixNormal and the
HeterogeneousMixture of different scalar families. None has a slab
form; the traced entries of the fused evaluation
(`vectorize/fused_traced.py`) serve Mixture, JointOrderStatistics and
Censored, as the JAX package's plan does. Reshaped's rank-2 event,
OrderStatistic's base cdf (ndtr of the state for a Normal base),
MatrixNormal's triangular solves and HeterogeneousMixture's support
masks decline there in both packages, and take the composed path.
"""

from __future__ import annotations

import math
from dataclasses import InitVar, dataclass

import torch

from . import _random as R
from ._special import betainc
from .base import REAL_MATRIX, Distribution, LeafDistribution, Support, _as_param, first_param

LOG2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class Mixture(Distribution):
    """Finite mixture of a batched component family: `components` carries
    the K parameter sets in its leading parameter axis (batch shape (K,));
    `log_weights` (K,), on the components' device unless `device` is
    given. logpdf = logsumexp_k [log softmax(w)_k + logpdf_k(x)]."""

    _leafwise_cdf = False

    components: Distribution
    log_weights: object
    device: InitVar[object] = None
    dtype: InitVar[object] = None

    def __post_init__(self, device, dtype):
        dev = first_param(self.components).device if device is None else torch.device(device)
        object.__setattr__(self, "log_weights", _as_param(self.log_weights, dev, dtype))

    @property
    def event_ndims(self):  # type: ignore[override]
        return self.components.event_ndims

    @property
    def event_shape(self):
        return self.components.event_shape

    def logpdf(self, x):
        lw = torch.log_softmax(self.log_weights, -1)
        return torch.logsumexp(lw + self.components.logpdf(x[..., None]), -1)

    def cdf(self, x):
        w = torch.softmax(self.log_weights, -1)
        return torch.sum(w * self.components.cdf(x[..., None]), -1)

    def sample(self, generator, sample_shape=()):
        """A component index by the weights, then that component's draw."""
        shape = tuple(sample_shape)
        comp = R.categorical(generator, self.log_weights, shape)
        draws = self.components.sample(generator, shape)  # shape + (K,)
        return torch.take_along_dim(draws, comp[..., None], dim=-1)[..., 0]

    @property
    def support(self):
        return self.components.support

    def to(self, device):
        return Mixture(self.components.to(device), self.log_weights.to(device))


@dataclass(frozen=True)
class JointOrderStatistics(Distribution):
    """All n order statistics of n iid draws from a scalar base, jointly:
    the support is the sorted vectors in the base's support, logpdf =
    log n! + sum logpdf on a sorted x, -inf on an unsorted one."""

    base: Distribution
    n: int

    event_ndims = 1

    def __post_init__(self):
        object.__setattr__(self, "n", int(self.n))

    @property
    def event_shape(self):
        return (self.n,)

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def logpdf(self, x):
        lgn = torch.lgamma(torch.as_tensor(self.n + 1.0, dtype=x.dtype, device=x.device))
        lp = lgn + torch.sum(self.base.logpdf(x), dim=-1)
        is_sorted = torch.all(x[..., 1:] >= x[..., :-1], dim=-1)
        return torch.where(is_sorted, lp, torch.full_like(lp, -math.inf))

    def sample(self, generator, sample_shape=()):
        draws = self.base.sample(generator, tuple(sample_shape) + (self.n,))
        return torch.sort(draws, dim=-1).values

    @property
    def support(self):
        return Support("joint_order")

    def to(self, device):
        return JointOrderStatistics(self.base.to(device), self.n)


@dataclass(frozen=True)
class Reshaped(Distribution):
    """The base's event reshaped to `shape` (reference
    ReshapedDistribution; the registry composes inverse(Reshape) o
    bijector(base) o Reshape, src/transformed_distribution.jl:144-149)."""

    base: Distribution
    shape: tuple

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if math.prod(int(s) for s in self.base.event_shape) != math.prod(self.shape):
            raise ValueError(f"cannot reshape event {self.base.event_shape} -> {self.shape}")

    @property
    def event_ndims(self):  # type: ignore[override]
        return len(self.shape)

    @property
    def event_shape(self):
        return self.shape

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def _to_base(self, x):
        batch = x.shape[: x.ndim - len(self.shape)]
        return x.reshape(tuple(batch) + tuple(int(s) for s in self.base.event_shape))

    def logpdf(self, x):
        return self.base.logpdf(self._to_base(x))

    def sample(self, generator, sample_shape=()):
        x = self.base.sample(generator, sample_shape)
        return x.reshape(tuple(x.shape[: x.ndim - self.base.event_ndims]) + self.shape)

    @property
    def support(self):
        return Support("reshaped")

    def to(self, device):
        return Reshaped(self.base.to(device), self.shape)


@dataclass(frozen=True)
class Censored(Distribution):
    """censored(base; lower, upper): values beyond the bounds collapse to
    point masses on them. logpdf is the mixed density: the base's in the
    interior, the log of the cdf's mass at the bounds."""

    base: Distribution
    lower: float = -math.inf
    upper: float = math.inf

    def __post_init__(self):
        object.__setattr__(self, "lower", float(self.lower))
        object.__setattr__(self, "upper", float(self.upper))

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def _at(self, bound, like):
        return torch.as_tensor(bound, dtype=like.dtype, device=like.device)

    def logpdf(self, x):
        lp = self.base.logpdf(x)
        if math.isfinite(self.lower):
            lp = torch.where(x <= self.lower, torch.log(self.base.cdf(self._at(self.lower, x))), lp)
        if math.isfinite(self.upper):
            lp = torch.where(x >= self.upper,
                             torch.log1p(-self.base.cdf(self._at(self.upper, x))), lp)
        return lp

    def sample(self, generator, sample_shape=()):
        return torch.clamp(self.base.sample(generator, sample_shape), self.lower, self.upper)

    def cdf(self, x):
        F = self.base.cdf(torch.clamp(x, self.lower, self.upper))
        if math.isfinite(self.lower):
            F = torch.where(x < self.lower, 0.0, F)
        if math.isfinite(self.upper):
            F = torch.where(x >= self.upper, 1.0, F)
        return F

    @property
    def support(self):
        bs = self.base.support
        lo = self.lower if math.isfinite(self.lower) else bs.lower
        hi = self.upper if math.isfinite(self.upper) else bs.upper

        def _fin(v):
            return isinstance(v, (int, float)) and math.isfinite(v)

        return Support("interval", lo, hi, _fin(lo) or bs.lower_finite,
                       _fin(hi) or bs.upper_finite)

    def to(self, device):
        return Censored(self.base.to(device), self.lower, self.upper)


@dataclass(frozen=True)
class OrderStatistic(Distribution):
    """The rank-th (1-based) order statistic of n iid draws from a scalar
    base (reference src/vector/order/order.jl:3-8: the base's link)."""

    base: Distribution
    n: int
    rank: int

    def __post_init__(self):
        object.__setattr__(self, "n", int(self.n))
        object.__setattr__(self, "rank", int(self.rank))

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def logpdf(self, x):
        n, r = self.n, self.rank
        F = torch.clamp(self.base.cdf(x), 1e-300, 1.0)
        logc = math.lgamma(n + 1.0) - math.lgamma(float(r)) - math.lgamma(n - r + 1.0)
        return (logc + (r - 1.0) * torch.log(F) + (n - r) * torch.log1p(-F)
                + self.base.logpdf(x))

    def sample(self, generator, sample_shape=()):
        draws = self.base.sample(generator, tuple(sample_shape) + (self.n,))
        return torch.sort(draws, dim=-1).values[..., self.rank - 1]

    def cdf(self, x):
        """I_F(x)(r, n - r + 1), the regularized incomplete beta."""
        F = self.base.cdf(x)
        r = torch.as_tensor(float(self.rank), dtype=F.dtype, device=F.device)
        return betainc(r, self.n - r + 1.0, F)

    @property
    def support(self):
        return self.base.support

    def to(self, device):
        return OrderStatistic(self.base.to(device), self.n, self.rank)


@dataclass(frozen=True)
class MatrixNormal(LeafDistribution):
    """The matrix normal MN(M, U, V), U and V given by their lower Cholesky
    factors (the identity link, reference src/vector/matrix/normal.jl)."""

    loc: object
    row_chol: object
    col_chol: object

    _params = ("loc", "row_chol", "col_chol")
    event_ndims = 2

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-2:])

    @property
    def batch_shape(self):
        return tuple(self.loc.shape[:-2])

    def logpdf(self, X):
        n, p = self.event_shape
        Lu, Lv = torch.tril(self.row_chol), torch.tril(self.col_chol)
        D = X - self.loc
        A = torch.linalg.solve_triangular(Lu.expand(D.shape[:-2] + Lu.shape[-2:]), D,
                                          upper=False)
        At = A.transpose(-1, -2)
        B = torch.linalg.solve_triangular(Lv.expand(At.shape[:-2] + Lv.shape[-2:]), At,
                                          upper=False)
        quad = torch.sum(B * B, dim=(-2, -1))
        logdet_u = torch.sum(torch.log(torch.diagonal(Lu, dim1=-2, dim2=-1)), -1)
        logdet_v = torch.sum(torch.log(torch.diagonal(Lv, dim1=-2, dim2=-1)), -1)
        return -0.5 * (quad + n * p * LOG2PI) - p * logdet_u - n * logdet_v

    def sample(self, generator, sample_shape=()):
        n, p = self.event_shape
        Z = R.normal(generator, tuple(sample_shape) + self.batch_shape + (n, p), self.loc)
        return self.loc + torch.tril(self.row_chol) @ Z @ torch.tril(self.col_chol).transpose(-1, -2)

    @property
    def support(self):
        return REAL_MATRIX


@dataclass(frozen=True)
class HeterogeneousMixture(Distribution):
    """A finite mixture of different scalar families (the reference's
    heterogeneous MixtureModel rows, test/vector/univariate.jl:96-99):
    `components` a tuple of scalar-event distributions, `log_weights` (K,)
    on the first component's device. logpdf = logsumexp_k [log w_k +
    logpdf_k(x)], a component contributing no density outside its own
    support."""

    components: tuple
    log_weights: object
    device: InitVar[object] = None
    dtype: InitVar[object] = None

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "components", tuple(self.components))
        for c in self.components:
            if c.event_ndims != 0:
                raise ValueError("HeterogeneousMixture needs scalar-event components")
        like = first_param(self.components[0])
        dev = like.device if device is None else torch.device(device)
        object.__setattr__(self, "log_weights",
                           _as_param(self.log_weights, dev, dtype or like.dtype))

    @staticmethod
    def _interior_point(s):
        if s.lower_finite and s.upper_finite:
            return 0.5 * (s.lower + s.upper)
        if s.lower_finite:
            return s.lower + 1.0
        if s.upper_finite:
            return s.upper - 1.0
        return 0.0

    def logpdf(self, x):
        lw = torch.log_softmax(self.log_weights, -1)
        # the mixture's support is the hull of its components': each
        # component is evaluated at an interior point where x lies outside
        # its own support (so no NaN reaches the value or the gradient),
        # its term -inf there
        parts = []
        for c in self.components:
            ok = c.in_support(x)
            x_safe = torch.where(ok, x, self._interior_point(c.support))
            parts.append(torch.where(ok, c.logpdf(x_safe), -math.inf))
        return torch.logsumexp(lw + torch.stack(parts, -1), -1)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape)
        comp = R.categorical(generator, self.log_weights, shape)
        draws = torch.stack([c.sample(generator, shape) for c in self.components], -1)
        return torch.take_along_dim(draws, comp[..., None], dim=-1)[..., 0]

    def cdf(self, x):
        w = torch.softmax(self.log_weights, -1)
        return sum(w[i] * c.cdf(x) for i, c in enumerate(self.components))

    @property
    def support(self):
        """The hull of the components' supports."""
        los, his, lfs, ufs = [], [], [], []
        for c in self.components:
            s = c.support
            if s.kind != "interval":
                raise ValueError("mixture components must have interval support")
            los.append(s.lower if s.lower_finite else -math.inf)
            his.append(s.upper if s.upper_finite else math.inf)
            lfs.append(s.lower_finite)
            ufs.append(s.upper_finite)
        lo = min(los) if all(lfs) else -math.inf
        hi = max(his) if all(ufs) else math.inf
        return Support("interval", lo, hi, all(lfs) and math.isfinite(lo),
                       all(ufs) and math.isfinite(hi))

    def to(self, device):
        return HeterogeneousMixture(tuple(c.to(device) for c in self.components),
                                    self.log_weights.to(device))
