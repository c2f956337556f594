"""Scalar bijectors, PyTorch counterpart of `tpu_bijectors/bijectors/scalar.py`.

`Truncated` is the link the registry gives every interval-supported family
(for LogNormal the lower-only log branch); `SignFlip` turns a decreasing
link increasing in the ordered links of the joint order statistics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils import clamp, log1pexp, logistic, logit
from .base import Bijector


@dataclass(frozen=True)
class Truncated(Bijector):
    """Support-of-truncated-distribution bijector (reference
    TruncatedBijector, src/bijectors/truncated.jl). The branch is chosen
    from the static bound flags:

      both finite   -> logit((x-lb)/(ub-lb))
      lower only    -> log(x - lb)
      upper only    -> log(ub - x)
      neither       -> identity

    Inputs are clamped to the bounds first (truncated.jl:17)."""

    lb: float = -math.inf
    ub: float = math.inf
    lower_finite: bool = False
    upper_finite: bool = False

    @property
    def monotonically_increasing(self):  # type: ignore[override]
        # truncated.jl:95-109
        return self.lower_finite or not self.upper_finite

    @property
    def monotonically_decreasing(self):  # type: ignore[override]
        return self.upper_finite and not self.lower_finite

    def forward_and_log_det(self, x):
        lb, ub = self.lb, self.ub
        if self.lower_finite and self.upper_finite:
            x = clamp(x, lb, ub)
            y = logit((x - lb) / (ub - lb))
            ld = -(torch.log(x - lb) + torch.log(ub - x) - math.log(ub - lb))
        elif self.lower_finite:
            d = torch.clamp_min(x, lb) - lb
            y = torch.log(d)
            ld = -torch.log(d)
        elif self.upper_finite:
            d = ub - torch.clamp_max(x, ub)
            y = torch.log(d)
            ld = -torch.log(d)
        else:
            y, ld = x, torch.zeros_like(x)
        return y, ld

    def inverse_and_log_det(self, y):
        lb, ub = self.lb, self.ub
        if self.lower_finite and self.upper_finite:
            x = clamp((ub - lb) * logistic(y) + lb, lb, ub)
            # stable inverse log-jacobian (truncated.jl:71-82)
            ay = torch.abs(y)
            ld = math.log(ub - lb) - ay - 2.0 * log1pexp(-ay)
        elif self.lower_finite:
            x = torch.clamp_min(torch.exp(y) + lb, lb)
            ld = y.clone()
        elif self.upper_finite:
            x = torch.clamp_max(ub - torch.exp(y), ub)
            ld = y.clone()
        else:
            x, ld = y, torch.zeros_like(y)
        return x, ld


@dataclass(frozen=True)
class SignFlip(Bijector):
    """x -> -x, log|J| = 0 (reference src/bijectors/ordered.jl:1-7)."""

    monotonically_decreasing = True

    def forward_and_log_det(self, x):
        return -x, torch.zeros_like(x)

    def inverse_and_log_det(self, y):
        return -y, torch.zeros_like(y)
