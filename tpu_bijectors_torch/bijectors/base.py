"""Bijector protocol (layer L1), PyTorch counterpart of
`tpu_bijectors/bijectors/base.py`.

`forward_and_log_det` / `inverse_and_log_det` are the primitives; the rest
derives. Inputs carry any leading batch dims; scalar bijectors
(event_ndims 0) return elementwise log-dets and `Block` sums them over
trailing event dims (reference `elementwise(f)`, src/interface.jl:33).
`Invert` and `inverse(b)` swap the two directions (a bijector with a
closed-form inverse of its own names it in `_self_inverse`); `Chain`
composes bijectors right to left, sums each member's log-det down to the
chain's batch shape and derives its monotonicity from its members' by the
sign table of src/interface.jl:340-360. `b >> c` is c after b.

A bijector that may hold tensors is a frozen dataclass made by
`bijector_dataclass`, whose `==` compares fields by value: a tensor field equals another of the same
shape and values (a scalar never equals a shape-(2,) tensor), as the JAX
package's pytree equality does (`tpu_bijectors/tree.py:42-75`); its hash
agrees with that `==`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import sum_last


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray, np.generic))


def _as_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _value_eq(a, b) -> bool:
    """Field equality: tuples and lists elementwise, arrays (and a number
    beside an array) by shape and value, anything else by its own `==`."""
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_value_eq(x, y) for x, y in zip(a, b)))
    if _is_array(a) or _is_array(b):
        if not all(_is_array(v) or isinstance(v, (int, float, bool)) for v in (a, b)):
            return False
        a1, a2 = _as_numpy(a), _as_numpy(b)
        return a1.shape == a2.shape and bool(np.array_equal(a1, a2))
    return bool(a == b)


def _value_hash(v) -> int:
    """A hash that agrees with `_value_eq`: an array hashes its shape and
    values, a 0-d one as its number."""
    if isinstance(v, (tuple, list)):
        return hash((type(v).__name__,) + tuple(_value_hash(e) for e in v))
    if _is_array(v):
        a = _as_numpy(v)
        return hash(a.item()) if a.ndim == 0 else hash((a.shape, tuple(a.ravel().tolist())))
    try:
        return hash(v)
    except TypeError:
        return id(v)


def _dataclass_eq(self, other):
    if type(self) is not type(other):
        return NotImplemented
    return all(_value_eq(getattr(self, f.name), getattr(other, f.name))
               for f in dataclasses.fields(self) if f.compare)


def _dataclass_hash(self):
    return hash((type(self).__name__,) + tuple(
        _value_hash(getattr(self, f.name)) for f in dataclasses.fields(self) if f.compare))


def bijector_dataclass(cls):
    """A frozen dataclass with the value-based `==` and hash above."""
    cls = dataclass(frozen=True, eq=False)(cls)
    cls.__eq__ = _dataclass_eq
    cls.__hash__ = _dataclass_hash
    return cls


class Transform:
    """Abstract transform (reference `Transform`, src/interface.jl:106-135):
    subclasses implement `forward_and_log_det` and, unless the inverse has
    no closed form, `inverse`."""

    event_ndims_in: int = 0
    event_ndims_out: int = 0
    # reference `isinvertible` (src/interface.jl:271-273)
    invertible: bool = True
    # whether the inverse has a closed form (reference `isclosedform`,
    # src/interface.jl:231)
    closed_form_inverse: bool = True
    # an elementwise map's direction (src/interface.jl:307-360; the
    # ordered links need a monotone one)
    monotonically_increasing: bool = False
    monotonically_decreasing: bool = False

    def forward_and_log_det(self, x):
        raise NotImplementedError(type(self).__name__)

    def forward(self, x):
        return self.forward_and_log_det(x)[0]

    def forward_log_det_jacobian(self, x):
        return self.forward_and_log_det(x)[1]

    def __call__(self, x):
        # reference (t::Transform)(x) = transform(t, x), src/interface.jl:135
        return self.forward(x)

    def inverse(self, y):
        return self.inverse_and_log_det(y)[0]

    def inverse_and_log_det(self, y):
        """(x, -forward log-det at x), reference src/interface.jl:276-281."""
        x = self.inverse(y)
        return x, -self.forward_log_det_jacobian(x)

    def inverse_log_det_jacobian(self, y):
        return self.inverse_and_log_det(y)[1]

    def forward_event_shape(self, shape: tuple) -> tuple:
        return tuple(shape)

    def inverse_event_shape(self, shape: tuple) -> tuple:
        return tuple(shape)

    def __rshift__(self, other: "Transform") -> "Chain":
        """x -> other(self(x))."""
        return Chain((other, self))

    def __lshift__(self, other: "Transform") -> "Chain":
        """x -> self(other(x))."""
        return Chain((self, other))


class Bijector(Transform):
    """Invertible transform (reference `Bijector`, src/interface.jl:264-273)."""

    invertible = True


@bijector_dataclass
class Invert(Bijector):
    """Lazy inverse wrapper (reference `Inverse`, src/interface.jl:246-281):
    its forward is the wrapped bijector's inverse and the reverse. An
    elementwise map's inverse keeps its direction."""

    bijector: Bijector

    @property
    def event_ndims_in(self):  # type: ignore[override]
        return self.bijector.event_ndims_out

    @property
    def event_ndims_out(self):  # type: ignore[override]
        return self.bijector.event_ndims_in

    @property
    def closed_form_inverse(self):  # type: ignore[override]
        return True

    @property
    def monotonically_increasing(self):  # type: ignore[override]
        return self.bijector.monotonically_increasing

    @property
    def monotonically_decreasing(self):  # type: ignore[override]
        return self.bijector.monotonically_decreasing

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


def inverse(b: Transform) -> Transform:
    """Involutive inverse (reference `inverse`, src/interface.jl:265-269):
    a bijector's own closed-form inverse where it names one
    (`_self_inverse`, so that `inverse(Exp())` is `Log()`), else `Invert`."""
    if isinstance(b, Invert):
        return b.bijector
    inv = getattr(b, "_self_inverse", None)
    return inv() if inv is not None else Invert(b)


def _chain_sign(transforms) -> int:
    """+1 (increasing), -1 (decreasing) or 0 (neither) of a composition,
    by the table of src/interface.jl:340-360: a decreasing member flips
    the sign, a member of no declared direction ends it."""
    sign = 1
    for t in transforms:
        if t.monotonically_increasing:
            continue
        if not t.monotonically_decreasing:
            return 0
        sign = -sign
    return sign


@bijector_dataclass
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

    @property
    def closed_form_inverse(self):  # type: ignore[override]
        return all(t.closed_form_inverse for t in self.transforms)

    @property
    def monotonically_increasing(self):  # type: ignore[override]
        return _chain_sign(self.transforms) > 0

    @property
    def monotonically_decreasing(self):  # type: ignore[override]
        return _chain_sign(self.transforms) < 0

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


@bijector_dataclass
class Identity(Bijector):
    """Identity with zero log-det."""

    monotonically_increasing = True

    def forward_and_log_det(self, x):
        return x, torch.zeros_like(x)

    def inverse_and_log_det(self, y):
        return y, torch.zeros_like(y)

    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def _self_inverse(self):
        return self


@bijector_dataclass
class Block(Bijector):
    """A scalar bijector over `ndims` extra trailing event dims, its
    log-det summed over them; its traits are its bijector's."""

    bijector: Bijector
    ndims: int

    @property
    def event_ndims_in(self):  # type: ignore[override]
        return self.bijector.event_ndims_in + self.ndims

    @property
    def event_ndims_out(self):  # type: ignore[override]
        return self.bijector.event_ndims_out + self.ndims

    @property
    def monotonically_increasing(self):  # type: ignore[override]
        return self.bijector.monotonically_increasing

    @property
    def monotonically_decreasing(self):  # type: ignore[override]
        return self.bijector.monotonically_decreasing

    @property
    def closed_form_inverse(self):  # type: ignore[override]
        return self.bijector.closed_form_inverse

    def forward_and_log_det(self, x):
        y, ld = self.bijector.forward_and_log_det(x)
        return y, sum_last(ld, self.ndims)

    def inverse_and_log_det(self, y):
        x, ld = self.bijector.inverse_and_log_det(y)
        return x, sum_last(ld, self.ndims)

    def forward_event_shape(self, shape):
        keep, inner = tuple(shape[: self.ndims]), shape[self.ndims:]
        return keep + tuple(self.bijector.forward_event_shape(inner))

    def inverse_event_shape(self, shape):
        keep, inner = tuple(shape[: self.ndims]), shape[self.ndims:]
        return keep + tuple(self.bijector.inverse_event_shape(inner))


def elementwise(b: Bijector, ndims: int) -> Bijector:
    """Apply a scalar bijector over `ndims` trailing event dims."""
    return b if ndims == 0 else Block(b, ndims)
