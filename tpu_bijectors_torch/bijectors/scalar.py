"""Scalar bijectors, PyTorch counterpart of `tpu_bijectors/bijectors/scalar.py`:
exp/log (reference src/bijectors/exp_log.jl), Logit (logit.jl), Shift
(shift.jl), Scale (scale.jl), LeakyReLU (leaky_relu.jl), Softplus,
Truncated (truncated.jl) and SignFlip (ordered.jl:1-7).

All act elementwise (event_ndims 0) and return elementwise log-dets; wrap
one in `Block` to sum over event dims. They are plain torch on either
device: the JAX package computes them in jnp, outside any kernel.
`Truncated` is the link the registry gives every interval-supported family
(for LogNormal the lower-only log branch); `SignFlip` turns a decreasing
link increasing in the ordered links of the joint order statistics.
"""

from __future__ import annotations

import math

import torch

from ..utils import clamp, log1pexp, logistic, logit, softplus_inv
from .base import Bijector, bijector_dataclass


def _as_tensor(v, like):
    """A parameter as a tensor of `like`'s dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


@bijector_dataclass
class Exp(Bijector):
    """y = exp(x); log|J| = x (reference src/bijectors/exp_log.jl:1-6)."""

    monotonically_increasing = True

    def forward_and_log_det(self, x):
        return torch.exp(x), x

    def inverse_and_log_det(self, y):
        x = torch.log(y)
        return x, -x

    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def _self_inverse(self):
        return Log()


@bijector_dataclass
class Log(Bijector):
    """y = log(x); log|J| = -y (reference src/bijectors/exp_log.jl:7-12)."""

    monotonically_increasing = True

    def forward_and_log_det(self, x):
        y = torch.log(x)
        return y, -y

    def inverse_and_log_det(self, y):
        return torch.exp(y), y

    def forward(self, x):
        return torch.log(x)

    def inverse(self, y):
        return torch.exp(y)

    def _self_inverse(self):
        return Exp()


@bijector_dataclass
class Logit(Bijector):
    """y = logit((x - a) / (b - a)); log|J| = -log((x - a)(b - x) / (b - a))
    (reference src/bijectors/logit.jl:15-30)."""

    a: object = 0.0
    b: object = 1.0

    monotonically_increasing = True

    def forward_and_log_det(self, x):
        a, b = self.a, self.b
        y = logit((x - a) / (b - a))
        ld = -(torch.log(x - a) + torch.log(b - x) - torch.log(_as_tensor(b - a, x)))
        return y, ld

    def inverse_and_log_det(self, y):
        a, b = self.a, self.b
        # stable: log|dx/dy| = log(b - a) - |y| - 2 log1pexp(-|y|)
        ay = torch.abs(y)
        return self.inverse(y), torch.log(_as_tensor(b - a, y)) - ay - 2.0 * log1pexp(-ay)

    def forward(self, x):
        return logit((x - self.a) / (self.b - self.a))

    def inverse(self, y):
        return (self.b - self.a) * logistic(y) + self.a


@bijector_dataclass
class Shift(Bijector):
    """y = x + a; log|J| = 0 (reference src/bijectors/shift.jl)."""

    a: object

    monotonically_increasing = True

    def forward_and_log_det(self, x):
        y = x + self.a
        return y, torch.zeros_like(y)

    def inverse_and_log_det(self, y):
        x = y - self.a
        return x, torch.zeros_like(x)

    def forward(self, x):
        return x + self.a

    def inverse(self, y):
        return y - self.a


@bijector_dataclass
class Scale(Bijector):
    """y = a x elementwise; log|J| = log|a| (reference
    src/bijectors/scale.jl:13-36; the matrix form is `LinearMap`). Its
    direction is declared only where the sign of `a` is static (a python
    number): increasing for a > 0, decreasing for a < 0."""

    a: object

    @property
    def monotonically_increasing(self):  # type: ignore[override]
        return isinstance(self.a, (int, float)) and self.a > 0

    @property
    def monotonically_decreasing(self):  # type: ignore[override]
        return isinstance(self.a, (int, float)) and self.a < 0

    def forward_and_log_det(self, x):
        y = x * self.a
        return y, torch.log(torch.abs(_as_tensor(self.a, y))).expand(y.shape)

    def inverse_and_log_det(self, y):
        x = y / self.a
        return x, -torch.log(torch.abs(_as_tensor(self.a, x))).expand(x.shape)

    def forward(self, x):
        return x * self.a

    def inverse(self, y):
        return y / self.a


@bijector_dataclass
class LeakyReLU(Bijector):
    """y = x for x >= 0, alpha x below (reference src/bijectors/leaky_relu.jl)."""

    alpha: object = 0.01

    monotonically_increasing = True

    def _slope(self, v, inv):
        alpha = _as_tensor(self.alpha, v)
        j = torch.where(v < 0, 1.0 / alpha if inv else alpha, torch.ones_like(v))
        return v * j, torch.log(torch.abs(j))

    def forward_and_log_det(self, x):
        return self._slope(x, False)

    def inverse_and_log_det(self, y):
        return self._slope(y, True)

    def forward(self, x):
        return torch.where(x < 0, x * self.alpha, x)

    def inverse(self, y):
        return torch.where(y < 0, y / self.alpha, y)


@bijector_dataclass
class Softplus(Bijector):
    """y = log(1 + e^x), R -> R+; log|J| = log sigmoid(x) = -log1pexp(-x)."""

    monotonically_increasing = True

    def forward_and_log_det(self, x):
        return log1pexp(x), -log1pexp(-x)

    def inverse_and_log_det(self, y):
        x = softplus_inv(y)
        return x, log1pexp(-x)

    def forward(self, x):
        return log1pexp(x)

    def inverse(self, y):
        return softplus_inv(y)


@bijector_dataclass
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


@bijector_dataclass
class SignFlip(Bijector):
    """x -> -x, log|J| = 0 (reference src/bijectors/ordered.jl:1-7)."""

    monotonically_decreasing = True

    def forward_and_log_det(self, x):
        return -x, torch.zeros_like(x)

    def inverse_and_log_det(self, y):
        return -y, torch.zeros_like(y)

    def _self_inverse(self):
        return self
