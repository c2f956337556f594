"""Bijector protocol (layer L1), PyTorch counterpart of
`tpu_bijectors/bijectors/base.py`.

`forward_and_log_det` / `inverse_and_log_det` are the primitives; the rest
derives. Inputs carry any leading batch dims; scalar bijectors
(event_ndims 0) return elementwise log-dets and `Block` sums them over
trailing event dims (reference `elementwise(f)`, src/interface.jl:33).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import sum_last


class Bijector:
    """Invertible transform (reference `Bijector`, src/interface.jl:264-273)."""

    event_ndims_in: int = 0
    event_ndims_out: int = 0

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


@dataclass(frozen=True)
class Identity(Bijector):
    """Identity with zero log-det."""

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
