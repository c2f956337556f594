"""Product and named bijectors, PyTorch counterparts of
`tpu_bijectors/bijectors/product.py` (reference
src/bijectors/product_bijector.jl and named_bijector.jl: NamedTransform,
NamedCoupling). The reference's field-wise unrolling is a Python loop over
the static structure.
"""

from __future__ import annotations

import math

import torch

from ..utils import sum_last
from .base import Bijector, bijector_dataclass


@bijector_dataclass
class ProductBijector(Bijector):
    """`bijectors[i]` on slice i of the leading `ndims` event axes of x:
    the event shape is stack_shape + the members' event shape
    (product_bijector.jl:18-55 slices trailing dims; the stack axes lead
    here, as batches do). For heterogeneous slices; a homogeneous stack is
    one `Block`."""

    bijectors: tuple  # flat, prod(stack_shape) members
    stack_shape: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "bijectors", tuple(self.bijectors))
        if not self.stack_shape:
            object.__setattr__(self, "stack_shape", (len(self.bijectors),))
        object.__setattr__(self, "stack_shape", tuple(int(s) for s in self.stack_shape))

    @property
    def ndims(self) -> int:
        return len(self.stack_shape)

    @property
    def event_ndims_in(self):  # type: ignore[override]
        return self.ndims + self.bijectors[0].event_ndims_in

    @property
    def event_ndims_out(self):  # type: ignore[override]
        return self.ndims + self.bijectors[0].event_ndims_out

    def _apply(self, x, method):
        stack_start = x.ndim - self.event_ndims_in
        batch = tuple(x.shape[:stack_start])
        inner = tuple(x.shape[stack_start + self.ndims:])
        xf = x.reshape(batch + (math.prod(self.stack_shape),) + inner)
        ys, ld = [], None
        for i, b in enumerate(self.bijectors):
            yi, ldi = getattr(b, method)(xf[(Ellipsis, i) + (slice(None),) * len(inner)])
            if b.event_ndims_in == 0 and inner:
                ldi = sum_last(ldi, len(inner))
            ys.append(yi)
            ld = ldi if ld is None else ld + ldi
        y = torch.stack(ys, dim=len(batch))
        return y.reshape(batch + self.stack_shape + tuple(ys[0].shape[len(batch):])), ld

    def forward_and_log_det(self, x):
        return self._apply(x, "forward_and_log_det")

    def inverse_and_log_det(self, y):
        return self._apply(y, "inverse_and_log_det")

    def forward_event_shape(self, shape):
        return tuple(shape[: self.ndims]) + tuple(
            self.bijectors[0].forward_event_shape(shape[self.ndims:]))

    def inverse_event_shape(self, shape):
        return tuple(shape[: self.ndims]) + tuple(
            self.bijectors[0].inverse_event_shape(shape[self.ndims:]))


def _total(b, ld):
    """A member's log-det of one field: a scalar member's summed over the
    field's whole shape."""
    return torch.sum(ld) if b.event_ndims_in == 0 else ld


@bijector_dataclass
class NamedTransform(Bijector):
    """Bijectors applied field by field to a dict; other fields pass
    through (reference NamedTransform, named_bijector.jl:27-91). The
    log-det is the sum over the fields."""

    bijectors: tuple  # one for each of `keys`, in order
    keys: tuple

    @classmethod
    def of(cls, **bij):
        keys = tuple(sorted(bij))
        return cls(tuple(bij[k] for k in keys), keys)

    def _map(self, x: dict, method):
        out, ld = dict(x), None
        for k, b in zip(self.keys, self.bijectors):
            out[k], ldi = getattr(b, method)(x[k])
            ldi = _total(b, ldi)
            ld = ldi if ld is None else ld + ldi
        if ld is None:
            ld = torch.zeros(())
        return out, ld

    def forward_and_log_det(self, x):
        return self._map(x, "forward_and_log_det")

    def inverse_and_log_det(self, y):
        return self._map(y, "inverse_and_log_det")


@bijector_dataclass
class NamedCoupling(Bijector):
    """x[target] through the bijector `bij_fn(*x[deps])` (reference
    NamedCoupling, named_bijector.jl:96-154)."""

    target: str
    deps: tuple
    bij_fn: object  # callable

    def _apply(self, x: dict, method):
        b = self.bij_fn(*(x[d] for d in self.deps))
        out = dict(x)
        out[self.target], ld = getattr(b, method)(x[self.target])
        return out, _total(b, ld)

    def forward_and_log_det(self, x):
        return self._apply(x, "forward_and_log_det")

    def inverse_and_log_det(self, y):
        return self._apply(y, "inverse_and_log_det")
