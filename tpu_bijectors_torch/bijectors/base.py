"""Bijector protocol (layer L1), PyTorch counterpart of
`tpu_bijectors/bijectors/base.py`.

`forward_and_log_det` / `inverse_and_log_det` are the primitives; the rest
derives. Inputs carry any leading batch dims; scalar bijectors
(event_ndims 0) return elementwise log-dets and `Block` sums them over
trailing event dims (reference `elementwise(f)`, src/interface.jl:33).
`Invert` and `inverse(b)` swap the two directions; `Chain` composes
bijectors right to left and sums each member's log-det down to the
chain's batch shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import sum_last


class Bijector:
    """Invertible transform (reference `Bijector`, src/interface.jl:264-273)."""

    event_ndims_in: int = 0
    event_ndims_out: int = 0
    # an elementwise map's direction (the ordered links need a monotone one)
    monotonically_increasing: bool = False
    monotonically_decreasing: bool = False

    def forward_and_log_det(self, x):
        raise NotImplementedError(type(self).__name__)

    def inverse_and_log_det(self, y):
        raise NotImplementedError(type(self).__name__)

    def forward(self, x):
        return self.forward_and_log_det(x)[0]

    def inverse(self, y):
        return self.inverse_and_log_det(y)[0]

    def forward_event_shape(self, shape: tuple) -> tuple:
        return tuple(shape)

    def inverse_event_shape(self, shape: tuple) -> tuple:
        return tuple(shape)


@dataclass(frozen=True)
class Invert(Bijector):
    """Lazy inverse wrapper (reference `Inverse`, src/interface.jl:246-281):
    its forward is the wrapped bijector's inverse and the reverse."""

    bijector: Bijector

    @property
    def event_ndims_in(self):  # type: ignore[override]
        return self.bijector.event_ndims_out

    @property
    def event_ndims_out(self):  # type: ignore[override]
        return self.bijector.event_ndims_in

    def forward_and_log_det(self, y):
        return self.bijector.inverse_and_log_det(y)

    def inverse_and_log_det(self, x):
        return self.bijector.forward_and_log_det(x)

    def forward(self, y):
        return self.bijector.inverse(y)

    def inverse(self, x):
        return self.bijector.forward(x)

    def forward_event_shape(self, shape):
        return self.bijector.inverse_event_shape(shape)

    def inverse_event_shape(self, shape):
        return self.bijector.forward_event_shape(shape)


def inverse(b: Bijector) -> Bijector:
    """Involutive inverse (reference `inverse`, src/interface.jl:265-269)."""
    return b.bijector if isinstance(b, Invert) else Invert(b)


@dataclass(frozen=True)
class Chain(Bijector):
    """Composition outer o ... o inner, applied right to left as Julia's
    `∘` (reference src/bijectors/composed.jl:4-14):
    `Chain((f, g)).forward(x) == f.forward(g.forward(x))`. Nested chains
    flatten at construction."""

    transforms: tuple

    def __post_init__(self):
        flat = []
        for t in self.transforms:
            flat.extend(t.transforms if isinstance(t, Chain) else (t,))
        object.__setattr__(self, "transforms", tuple(flat))

    def _propagate_event_ndims(self):
        """(event_ndims_in, event_ndims_out), walking members inner to
        outer: a member that needs more trailing event dims than the value
        carries pulls them from the batch, one that needs fewer broadcasts
        over the rest."""
        ndims_in = cur_out = 0
        for t in reversed(self.transforms):
            need = int(t.event_ndims_in)
            if need > cur_out:
                ndims_in += need - cur_out
                cur_out = int(t.event_ndims_out)
            else:
                cur_out = (cur_out - need) + int(t.event_ndims_out)
        return ndims_in, cur_out

    @property
    def event_ndims_in(self):  # type: ignore[override]
        return self._propagate_event_ndims()[0]

    @property
    def event_ndims_out(self):  # type: ignore[override]
        return self._propagate_event_ndims()[1]

    def forward_and_log_det(self, x):
        batch_ndim = _batch_ndim_of(x, self.event_ndims_in)
        logdet = None
        for t in reversed(self.transforms):
            x, ld = t.forward_and_log_det(x)
            ld = _reduce_to_batch(ld, batch_ndim)
            logdet = ld if logdet is None else logdet + ld
        return x, logdet

    def forward(self, x):
        for t in reversed(self.transforms):
            x = t.forward(x)
        return x

    def inverse_and_log_det(self, y):
        batch_ndim = _batch_ndim_of(y, self.event_ndims_out)
        logdet = None
        for t in self.transforms:
            y, ld = t.inverse_and_log_det(y)
            ld = _reduce_to_batch(ld, batch_ndim)
            logdet = ld if logdet is None else logdet + ld
        return y, logdet

    def inverse(self, y):
        for t in self.transforms:
            y = t.inverse(y)
        return y

    def forward_event_shape(self, shape):
        for t in reversed(self.transforms):
            shape = t.forward_event_shape(shape)
        return shape

    def inverse_event_shape(self, shape):
        for t in self.transforms:
            shape = t.inverse_event_shape(shape)
        return shape


def _batch_ndim_of(x, event_ndims: int) -> int:
    """The number of leading batch dims of a chain's input tensor."""
    if x.ndim < event_ndims:
        raise ValueError(
            f"Chain input has {x.ndim} dims but the composition needs {event_ndims} event dims"
        )
    return x.ndim - event_ndims


def _reduce_to_batch(ld, batch_ndim: int):
    """Sum a member's log-det down to the chain's batch shape: a scalar
    member applied to a vector-valued intermediate returns an elementwise
    log-det, summed here over the dims beyond the chain's batch rank."""
    extra = ld.ndim - batch_ndim
    if extra < 0:
        raise ValueError(
            f"Chain member produced a log-det with fewer dims ({ld.ndim}) than the "
            f"chain batch rank ({batch_ndim}): a member mis-declares its event_ndims"
        )
    return sum_last(ld, extra)


@dataclass(frozen=True)
class Identity(Bijector):
    """Identity with zero log-det."""

    monotonically_increasing = True

    def forward_and_log_det(self, x):
        return x, torch.zeros_like(x)

    def inverse_and_log_det(self, y):
        return y, torch.zeros_like(y)


@dataclass(frozen=True)
class Block(Bijector):
    """A scalar bijector over `ndims` extra trailing event dims, its
    log-det summed over them."""

    bijector: Bijector
    ndims: int

    @property
    def event_ndims_in(self):  # type: ignore[override]
        return self.bijector.event_ndims_in + self.ndims

    @property
    def event_ndims_out(self):  # type: ignore[override]
        return self.bijector.event_ndims_out + self.ndims

    def forward_and_log_det(self, x):
        y, ld = self.bijector.forward_and_log_det(x)
        return y, sum_last(ld, self.ndims)

    def inverse_and_log_det(self, y):
        x, ld = self.bijector.inverse_and_log_det(y)
        return x, sum_last(ld, self.ndims)


def elementwise(b: Bijector, ndims: int) -> Bijector:
    """Apply a scalar bijector over `ndims` trailing event dims."""
    return b if ndims == 0 else Block(b, ndims)
