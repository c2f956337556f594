"""Multivariate families, PyTorch counterpart of
`tpu_bijectors/dists/multivariate.py`: Dirichlet."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bijectors.simplex import SimplexBijector, _simplex_inverse_logdet_wlog
from .base import SIMPLEX, LeafDistribution


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
