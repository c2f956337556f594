"""Distribution base, PyTorch counterpart of `tpu_bijectors/dists/base.py`.

Every distribution is a frozen dataclass. Leaf families hold their
parameters as tensors on one device, chosen at construction: `cuda` unless
the caller passes `device=` (see `utils.resolve_device`). `logpdf(x)` sums
over event dims and broadcasts over leading batch dims; `support` is the
static metadata the `bijector(d)` registry dispatches on (reference
src/Bijectors.jl:268-320).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import KW_ONLY, InitVar, dataclass
from typing import ClassVar

import numpy as np
import torch

from ..utils import resolve_device


@dataclass(frozen=True)
class Support:
    """Static support descriptor: kind 'interval' (with bounds and their
    finiteness), 'real_vector', 'simplex', 'corr', 'chol_corr', 'pd' or
    'product'."""

    kind: str = "interval"
    lower: float = -math.inf
    upper: float = math.inf
    lower_finite: bool = False
    upper_finite: bool = False


def real_line() -> Support:
    return Support("interval", -math.inf, math.inf, False, False)


def positive() -> Support:
    return Support("interval", 0.0, math.inf, True, False)


def unit_interval() -> Support:
    return Support("interval", 0.0, 1.0, True, True)


def interval(lo: float, hi: float) -> Support:
    """The finite interval (lo, hi)."""
    return Support("interval", lo, hi, True, True)


def lower_bounded(lo: float) -> Support:
    return Support("interval", lo, math.inf, True, False)


REAL_VECTOR = Support("real_vector")
SIMPLEX = Support("simplex")
CORRELATION = Support("corr")
CHOLESKY_CORRELATION = Support("chol_corr")
POSITIVE_DEFINITE = Support("pd")


class Distribution:
    """Abstract distribution."""

    event_ndims: int = 0

    @property
    def event_shape(self) -> tuple:
        return ()

    @property
    def batch_shape(self) -> tuple:
        return ()

    @property
    def support(self) -> Support:
        return real_line()

    def logpdf(self, x):
        raise NotImplementedError(type(self).__name__)

    def sample(self, generator, sample_shape: tuple = ()):
        """Draws of shape sample_shape + batch_shape + event_shape, every
        random number from `generator` (a `torch.Generator` on the
        parameters' device)."""
        raise NotImplementedError(type(self).__name__)

    def sample_and_logpdf(self, generator, sample_shape: tuple = ()):
        x = self.sample(generator, sample_shape)
        return x, self.logpdf(x)

    def in_support(self, x, atol: float = 1e-8):
        """Whether x lies in the support, to within atol (the property
        sweep's check, reference src/vector/test_utils.jl:325-374)."""
        s = self.support
        n = self.event_ndims
        if s.kind == "interval":
            ok = torch.ones_like(x, dtype=torch.bool)
            if s.lower_finite:
                ok = ok & (x >= s.lower - atol)
            if s.upper_finite:
                ok = ok & (x <= s.upper + atol)
            return torch.all(ok, dim=tuple(range(-n, 0))) if n else ok
        if s.kind == "simplex":
            return (torch.abs(torch.sum(x, -1) - 1.0) < max(atol, 1e-6)) & torch.all(x >= -atol, -1)
        if s.kind in ("pd", "corr"):
            eig = torch.linalg.eigvalsh(0.5 * (x + x.transpose(-1, -2)))
            ok = torch.all(eig > -atol, -1)
            if s.kind == "corr":
                d = torch.diagonal(x, dim1=-2, dim2=-1)
                ok = ok & torch.all(torch.abs(d - 1.0) < max(atol, 1e-6), -1)
            return ok
        if s.kind == "chol_corr":
            return torch.all(torch.diagonal(x, dim1=-2, dim2=-1) > -atol, -1)
        return torch.ones(x.shape[: x.ndim - n], dtype=torch.bool, device=x.device)

    def to(self, device) -> "Distribution":
        """The same distribution with every parameter on `device`."""
        raise NotImplementedError(type(self).__name__)


def _as_param(v, device, dtype):
    if isinstance(v, torch.Tensor):
        if dtype is None and not v.is_floating_point():
            dtype = torch.get_default_dtype()
        return v.to(device=device, dtype=dtype)
    # a copy: the distribution does not alias the caller's array
    return torch.tensor(
        np.asarray(v), dtype=dtype or torch.get_default_dtype(), device=device
    )


def first_param(d: Distribution):
    """The first tensor parameter of `d`, found through products, wrappers
    and a mixture's components (None where it has none): its dtype and
    device are the distribution's."""
    while not getattr(d, "_params", ()):
        if hasattr(d, "components"):
            d = d.components[0] if isinstance(d.components, tuple) else d.components
        elif hasattr(d, "base"):
            d = d.base
        else:
            return None
    return getattr(d, d._params[0])


@dataclass(frozen=True)
class LeafDistribution(Distribution):
    """A family with tensor parameters (named by `_params`), converted at
    construction to tensors of `dtype` (default: a floating tensor keeps
    its own, anything else takes torch's default) on `device`."""

    _params: ClassVar[tuple] = ()
    _: KW_ONLY
    device: InitVar[object] = None
    dtype: InitVar[object] = None

    def __post_init__(self, device, dtype):
        dev = resolve_device(device)
        for name in self._params:
            object.__setattr__(self, name, _as_param(getattr(self, name), dev, dtype))

    @property
    def batch_shape(self) -> tuple:
        n = self.event_ndims
        shapes = [tuple(getattr(self, p).shape) for p in self._params]
        return tuple(torch.broadcast_shapes(*(s[: len(s) - n] for s in shapes)))

    def to(self, device):
        moved = {p: getattr(self, p).to(device) for p in self._params}
        return dataclasses.replace(self, device=device, **moved)
