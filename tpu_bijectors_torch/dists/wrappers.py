"""Wrapper distributions, PyTorch counterpart of
`tpu_bijectors/dists/wrappers.py`: a finite Mixture of one batched scalar
family, and the JointOrderStatistics of n iid draws (reference
src/vector/order/order.jl:14-76). Neither has a slab form; the traced
entries of the fused evaluation (`vectorize/fused_traced.py`) serve both.
"""

from __future__ import annotations

import math
from dataclasses import InitVar, dataclass

import torch

from . import _random as R
from .base import Distribution, Support, _as_param, first_param


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
