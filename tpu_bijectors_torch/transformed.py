"""TransformedDistribution, PyTorch counterpart of
`tpu_bijectors/transformed.py` (reference src/transformed_distribution.jl):
the distribution of y = transform(x) for x ~ base.

  logpdf(td, y) = logpdf(base, b^-1(y)) + logdetJ(b^-1, y)
                  (transformed_distribution.jl:159-197)

`transformed(d)` takes the base's registry bijector, so y is unconstrained.
The registry's bijector of a TransformedDistribution composes the wrapper
away (`Chain((bijector(base), inverse(transform)))`,
transformed_distribution.jl:45-48), and its linked density telescopes to
the base's (`vectorize/core.py::TransformedUnconstrainer`).

`ordered(d)` restricts a multivariate `d` to sorted vectors (reference
src/bijectors/ordered.jl:83-168): its link is the inverse ordered
bijector after `d`'s own, sandwiched between sign flips where `d`'s
inverse link is decreasing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

import math

from .bijectors.base import Bijector, Block, Chain, inverse
from .bijectors.ordered import OrderedBijector
from .bijectors.scalar import SignFlip
from .dists.base import Distribution, Support
from .dists.product import IIDProduct
from .registry import _logpdf_eps_safe, bijector, register_bijector


def _sum_extra(ld, extra: int):
    return torch.sum(ld, dim=tuple(range(-extra, 0))) if extra > 0 else ld


@dataclass(frozen=True)
class TransformedDistribution(Distribution):
    """Distribution of y = transform(x), x ~ base."""

    base: Distribution
    transform: Bijector

    @property
    def event_ndims(self):  # type: ignore[override]
        n_in = int(self.transform.event_ndims_in)
        n_out = int(self.transform.event_ndims_out)
        base = self.base.event_ndims
        # a scalar bijector on a vector base keeps the base's event rank
        return base - n_in + n_out if n_in <= base else n_out

    @property
    def event_shape(self):
        return tuple(self.transform.forward_event_shape(tuple(self.base.event_shape)))

    @property
    def batch_shape(self):
        return self.base.batch_shape

    @property
    def support(self) -> Support:
        # unknown in general; the registry composes the transform instead
        return Support("unknown")

    def logpdf(self, y):
        x, ld = self.transform.inverse_and_log_det(y)
        extra = self.base.event_ndims - int(self.transform.event_ndims_in)
        return _logpdf_eps_safe(self.base, x) + _sum_extra(ld, extra)

    def sample(self, generator, sample_shape=()):
        return self.transform.forward(self.base.sample(generator, sample_shape))

    def sample_and_logpdf(self, generator, sample_shape=()):
        """(y, logpdf(y)) from the base's draw and the forward log-det, with
        no inverse."""
        x = self.base.sample(generator, sample_shape)
        y, ld = self.transform.forward_and_log_det(x)
        extra = self.base.event_ndims - int(self.transform.event_ndims_in)
        return y, self.base.logpdf(x) - _sum_extra(ld, extra)

    def to(self, device):
        return TransformedDistribution(self.base.to(device), self.transform)


def transformed(d: Distribution, b: Bijector | None = None) -> TransformedDistribution:
    """`transformed(d) = transformed(d, bijector(d))`
    (reference src/transformed_distribution.jl:37-38)."""
    return TransformedDistribution(d, bijector(d) if b is None else b)


# the rejection sampler's cap: acceptance is about 1/n! for a weakly
# coupled base, so the cap binds only on misuse (a large n)
MAX_REJECTION_ROUNDS = 100_000


def _is_sorted(x):
    return torch.all(x[..., 1:] >= x[..., :-1], dim=-1)


@dataclass(frozen=True)
class OrderedDistribution(Distribution):
    """A multivariate distribution restricted to sorted vectors,
    unnormalised (the caveats of ordered.jl:106-129)."""

    dist: Distribution
    transform: Bijector  # ordered -> unconstrained

    event_ndims = 1

    @property
    def event_shape(self):
        return tuple(self.dist.event_shape)

    @property
    def batch_shape(self):
        return self.dist.batch_shape

    @property
    def support(self) -> Support:
        return Support("ordered")

    def logpdf(self, x):
        lp = self.dist.logpdf(x)
        return torch.where(_is_sorted(x), lp, torch.full_like(lp, -math.inf))

    def sample(self, generator, sample_shape=()):
        """A draw of an exchangeable (IID) base, sorted, is a draw of its
        ordered restriction; any other base is sampled by rejection until
        sorted (ordered.jl:160-168), a row not accepted within
        MAX_REJECTION_ROUNDS rounds NaN."""
        x = self.dist.sample(generator, sample_shape)
        if isinstance(self.dist, IIDProduct):
            return torch.sort(x, dim=-1).values
        ok = _is_sorted(x)
        for _ in range(MAX_REJECTION_ROUNDS):
            if bool(ok.all()):
                break
            xn = self.dist.sample(generator, sample_shape)
            okn = _is_sorted(xn)
            x = torch.where((okn & ~ok)[..., None], xn, x)
            ok = ok | okn
        return torch.where(ok[..., None], x, torch.full_like(x, math.nan))

    def to(self, device):
        return ordered(self.dist.to(device))


def ordered(d: Distribution) -> OrderedDistribution:
    """The order-restricted `d` (reference `ordered`, ordered.jl:130-147)."""
    b = bijector(d)
    binv = inverse(b)
    flip = Block(SignFlip(), 1)  # a batch-shaped log-det, as OrderedBijector's
    if binv.monotonically_decreasing:
        ob = Chain((flip, inverse(OrderedBijector()), flip, b))
    elif binv.monotonically_increasing:
        ob = Chain((inverse(OrderedBijector()), b))
    else:
        raise ValueError(f"ordered transform not supported for {type(d).__name__}")
    return OrderedDistribution(d, ob)


@register_bijector(OrderedDistribution)
def _bijector_ordered(d: OrderedDistribution):
    return d.transform
