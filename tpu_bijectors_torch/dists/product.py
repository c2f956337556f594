"""Product distributions, PyTorch counterpart of
`tpu_bijectors/dists/product.py`: IIDProduct, ElementwiseProduct (the
`arraydist` of a family with per-element parameters), Product (a tuple
sample) and NamedProduct (a dict sample). A product's `sample` draws its
components one after another from the one generator."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import Distribution, Support


@dataclass(frozen=True)
class IIDProduct(Distribution):
    """n iid copies of a base distribution, stacked on a new leading event
    axis."""

    base: Distribution
    n: int

    @property
    def event_ndims(self):  # type: ignore[override]
        return self.base.event_ndims + 1

    @property
    def event_shape(self):
        return (self.n,) + tuple(self.base.event_shape)

    @property
    def batch_shape(self):
        return self.base.batch_shape

    @property
    def support(self) -> Support:
        return self.base.support

    def logpdf(self, x):
        return torch.sum(self.base.logpdf(x), dim=-1)

    def sample(self, generator, sample_shape=()):
        return self.base.sample(generator, tuple(sample_shape) + (self.n,))

    def in_support(self, x, atol: float = 1e-8):
        return torch.all(self.base.in_support(x, atol), dim=-1)

    def to(self, device):
        return IIDProduct(self.base.to(device), self.n)


@dataclass(frozen=True)
class ElementwiseProduct(Distribution):
    """The product of a scalar family with per-element parameters: `base`
    has batch shape (n,), a sample is an (n,) vector and logpdf sums the
    per-element densities (Distributions.jl `arraydist`, reference
    src/vector/product/product.jl). Shared parameters are an IIDProduct."""

    base: Distribution

    @property
    def n(self) -> int:
        return int(self.base.batch_shape[-1])

    @property
    def event_ndims(self):  # type: ignore[override]
        return self.base.event_ndims + 1

    @property
    def event_shape(self):
        return (self.n,) + tuple(self.base.event_shape)

    @property
    def support(self) -> Support:
        return self.base.support

    def logpdf(self, x):
        return torch.sum(self.base.logpdf(x), dim=-1)

    def sample(self, generator, sample_shape=()):
        # the base's draw is sample_shape + batch_shape = (..., n)
        return self.base.sample(generator, sample_shape)

    def in_support(self, x, atol: float = 1e-8):
        return torch.all(self.base.in_support(x, atol), dim=-1)

    def to(self, device):
        return ElementwiseProduct(self.base.to(device))


def arraydist(base: Distribution) -> ElementwiseProduct:
    """`arraydist(Normal(mu, sigma))` with (n,) parameters: n independent
    elements of one family. Raises unless `base` has a 1-D batch shape."""
    if len(base.batch_shape) != 1:
        raise ValueError(
            "arraydist needs a base with 1-D batch_shape (per-element "
            f"parameters); got {tuple(base.batch_shape)}"
        )
    return ElementwiseProduct(base)


@dataclass(frozen=True)
class Product(Distribution):
    """Heterogeneous product; a sample is the tuple of the components'."""

    components: tuple

    @property
    def event_shape(self):
        return tuple(c.event_shape for c in self.components)

    @property
    def support(self) -> Support:
        return Support("product")

    def logpdf(self, x):
        out = None
        for c, xi in zip(self.components, x):
            lp = c.logpdf(xi)
            out = lp if out is None else out + lp
        return out

    def sample(self, generator, sample_shape=()):
        return tuple(c.sample(generator, sample_shape) for c in self.components)

    def to(self, device):
        return Product(tuple(c.to(device) for c in self.components))


@dataclass(frozen=True)
class NamedProduct(Distribution):
    """Named heterogeneous product; a sample is a dict (reference
    ProductNamedTupleDistribution, src/bijectors/named_stacked.jl:64-95)."""

    components: tuple
    names: tuple

    @classmethod
    def of(cls, **dists):
        names = tuple(dists)
        return cls(tuple(dists[n] for n in names), names)

    @property
    def event_shape(self):
        return {n: c.event_shape for n, c in zip(self.names, self.components)}

    @property
    def support(self) -> Support:
        return Support("product")

    def logpdf(self, x):
        out = None
        for n, c in zip(self.names, self.components):
            lp = c.logpdf(x[n])
            out = lp if out is None else out + lp
        return out

    def sample(self, generator, sample_shape=()):
        return {n: c.sample(generator, sample_shape) for n, c in zip(self.names, self.components)}

    def to(self, device):
        return NamedProduct(tuple(c.to(device) for c in self.components), self.names)
