"""Invertible batch normalization for flows, PyTorch counterpart of
`tpu_bijectors/flows/normalise.py` (reference normalise.jl:41-88).

The layer is immutable, as the JAX package's pytree is:
`forward_and_log_det_train` returns `(y, logdet, updated_layer)` with the
running statistics moved, and leaves the layer it was called on as it
was. Channels are the last axis.

  eval:   y = exp(logs) * (x - m) / sqrt(v + eps) + b
  train:  m, v from the batch; the running statistics move with momentum
          `mtm`, the variance's with the n / (n - 1) correction
  logdetJ = sum(logs - log(v + eps) / 2), the same for every batch row
"""

from __future__ import annotations

import dataclasses

import torch

from ..bijectors.base import Bijector, bijector_dataclass
from ..utils import resolve_device


@bijector_dataclass
class InvertibleBatchNorm(Bijector):
    b: torch.Tensor  # bias (channels,)
    logs: torch.Tensor  # log-scale (channels,)
    m: torch.Tensor  # running mean
    v: torch.Tensor  # running variance
    eps: float = 1e-5
    mtm: float = 0.1

    event_ndims_in = 1
    event_ndims_out = 1

    @classmethod
    def init(cls, channels: int, eps: float = 1e-5, mtm: float = 0.1, dtype=torch.float32,
             device=None):
        z = torch.zeros(channels, dtype=dtype, device=resolve_device(device))
        return cls(z, z, z, torch.ones_like(z), eps, mtm)

    def _logdet(self, var):
        return torch.sum(self.logs - 0.5 * torch.log(var + self.eps))

    def forward_and_log_det(self, x):
        y = torch.exp(self.logs) * (x - self.m) / torch.sqrt(self.v + self.eps) + self.b
        return y, self._logdet(self.v).expand(x.shape[:-1])

    def inverse_and_log_det(self, y):
        return self.inverse(y), (-self._logdet(self.v)).expand(y.shape[:-1])

    def inverse(self, y):
        return (y - self.b) / torch.exp(self.logs) * torch.sqrt(self.v + self.eps) + self.m

    def forward_and_log_det_train(self, x):
        """Forward with the batch's statistics (over every axis but the
        last): (y, logdet, the layer with its running statistics moved)."""
        axes = tuple(range(x.ndim - 1))
        n = 1
        for a in axes:
            n *= x.shape[a]
        # torch.mean over dim=() reduces every axis: one row is its own mean
        m = torch.mean(x, dim=axes) if axes else x
        v = torch.mean((x - m) ** 2, dim=axes) if axes else torch.zeros_like(x)
        y = torch.exp(self.logs) * (x - m) / torch.sqrt(v + self.eps) + self.b
        mtm = self.mtm
        updated = dataclasses.replace(
            self, m=(1 - mtm) * self.m + mtm * m,
            v=(1 - mtm) * self.v + (mtm * n / max(n - 1, 1)) * v)
        return y, self._logdet(v).expand(x.shape[:-1]), updated
