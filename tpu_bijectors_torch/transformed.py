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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .bijectors.base import Bijector
from .dists.base import Distribution, Support
from .registry import _logpdf_eps_safe, bijector


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
