"""Stick-breaking simplex bijector, PyTorch counterpart of
`tpu_bijectors/bijectors/simplex.py` (plain path only).

Math (0-based k, eps = machine epsilon of the dtype; reference
src/bijectors/simplex.jl:28-138):

  forward:  s_k = sum_{i<k} x_i
            z_0 = x_0 * (1-2eps) + eps
            z_k = (x_k + eps) * (1-2eps) / ((1+eps) - s_k),   k >= 1
            y_k = logit(z_k) + log(K-1-k)
  inverse:  the same recurrence in the running sum, clamped per step
            (simplex.jl:84-100).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import _eps, clamp, logistic, logit
from .base import Bijector


def _log_km1_minus_k(K: int, like):
    # log(K-1-k) for k = 0..K-2
    return torch.as_tensor(
        np.log(np.arange(K - 1, 0, -1)), dtype=like.dtype, device=like.device
    )


def _exclusive_prefix(x, K):
    # s_k = sum_{i<k} x_i for k = 0..K-2
    s = torch.cumsum(x[..., : K - 2], dim=-1)
    return torch.cat([torch.zeros_like(x[..., :1]), s], dim=-1)


@dataclass(frozen=True)
class SimplexBijector(Bijector):
    """K-simplex -> R^{K-1} via stick-breaking (reference SimplexBijector)."""

    event_ndims_in = 1
    event_ndims_out = 1

    def forward_event_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def forward_and_log_det(self, x):
        return self.forward(x), self.forward_log_det_jacobian(x)

    def forward(self, x):
        K = x.shape[-1]
        if K < 2:
            raise ValueError("simplex dimension must be >= 2")
        eps = _eps(x.dtype)
        s = _exclusive_prefix(x, K)
        xk = x[..., : K - 1]
        z_first = xk * (1 - 2 * eps) + eps
        z_rest = (xk + eps) * (1 - 2 * eps) / ((1 + eps) - s)
        k_is_zero = torch.arange(K - 1, device=x.device) == 0
        z = torch.where(k_is_zero, z_first, z_rest)
        return logit(z) + _log_km1_minus_k(K, x)

    def forward_log_det_jacobian(self, x):
        K = x.shape[-1]
        eps = _eps(x.dtype)
        s = _exclusive_prefix(x, K)
        rem = torch.clamp_min(1.0 - s, eps)
        xk = x[..., : K - 1]
        k_is_zero = torch.arange(K - 1, device=x.device) == 0
        z = torch.where(k_is_zero, xk, xk / rem)
        lp = torch.log(torch.clamp_min(z, eps)) + torch.log(
            torch.clamp_min(1.0 - z, eps)
        )
        lp = lp + torch.where(k_is_zero, torch.zeros_like(rem), torch.log(rem))
        return -torch.sum(lp, dim=-1)

    def inverse_and_log_det(self, y):
        x = _simplex_inverse(y)
        return x, -self.forward_log_det_jacobian(x)


def _simplex_inverse(y):
    """Exact reference recurrence (simplex.jl:84-100) over K-1 steps; every
    batch dim rides along in each step."""
    K = y.shape[-1] + 1
    eps = _eps(y.dtype)
    z = logistic(y - _log_km1_minus_k(K, y))
    s = torch.zeros_like(z[..., 0])
    xs = []
    for k in range(K - 1):
        zk = z[..., k]
        if k == 0:
            xk = clamp((zk - eps) / (1 - 2 * eps), 0.0, 1.0)
        else:
            xk = clamp(((1 + eps) - s) / (1 - 2 * eps) * zk - eps, 0.0, 1.0)
        s = s + xk
        xs.append(xk)
    xs.append(clamp(1.0 - s, 0.0, 1.0))
    return torch.stack(xs, dim=-1)


def _simplex_inverse_logdet_wlog(y, am1):
    """(x, inverse log-det, sum_k am1[k] log(x_k + eps)). The eps-nudge is
    the reference's transformed-path Dirichlet density logpdf(d, x .+ eps)
    (src/Bijectors.jl:253): finite when the clamps saturate x to 0."""
    x, ld = SimplexBijector().inverse_and_log_det(y)
    return x, ld, torch.sum(am1 * torch.log(x + _eps(x.dtype)), dim=-1)
