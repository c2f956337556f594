"""Ordered-vector bijector, PyTorch counterpart of
`tpu_bijectors/bijectors/ordered.py` (reference src/bijectors/ordered.jl).

Forward maps unconstrained R^d to ordered vectors (ordered.jl:10-17):

  forward:  x = cumsum([y_0, exp(y_1), ..., exp(y_{d-1})])
  logdetJ:  sum(y[1:])                       (ordered.jl:79-80)
  inverse:  y_0 = x_0, y_i = log(x_i - x_{i-1})
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import Bijector


@dataclass(frozen=True)
class OrderedBijector(Bijector):
    """Unconstrained -> ordered (reference OrderedBijector)."""

    event_ndims_in = 1
    event_ndims_out = 1
    monotonically_increasing = False  # not elementwise monotone as a map

    def forward_and_log_det(self, y):
        return self.forward(y), torch.sum(y[..., 1:], dim=-1)

    def forward(self, y):
        steps = torch.cat([y[..., :1], torch.exp(y[..., 1:])], dim=-1)
        return torch.cumsum(steps, dim=-1)

    def inverse_and_log_det(self, x):
        y = self.inverse(x)
        return y, -torch.sum(y[..., 1:], dim=-1)

    def inverse(self, x):
        d = torch.log(x[..., 1:] - x[..., :-1])
        return torch.cat([x[..., :1], d], dim=-1)
