"""Radial flow layer, PyTorch counterpart of `tpu_bijectors/flows/radial.py`
(reference radial_layer.jl; Rezende & Mohamed 2015, eq. 14 and appendix
A.2):

  forward:  alpha = log1pexp(alpha_raw), beta_hat = -alpha + log1pexp(beta_raw)
            r = |z - z0|,  f(z) = z + beta_hat / (alpha + r) * (z - z0)
  logdetJ:  (d - 1) log(1 + beta_hat h) + log(1 + beta_hat h - beta_hat h^2 r),
            h = 1 / (alpha + r)
  inverse (closed form):
            gamma = |y - z0|, a = log1pexp(beta_raw) - gamma
            r = (sqrt(a^2 + 4 alpha gamma) - a) / 2
            z = z0 + (alpha + r) / (log1pexp(beta_raw) + r) * (y - z0)
"""

from __future__ import annotations

import torch

from ..bijectors.base import Bijector, bijector_dataclass
from ..utils import log1pexp, resolve_device


@bijector_dataclass
class RadialLayer(Bijector):
    """Trainable radial flow layer: alpha_raw, beta_raw scalars, z0 (d,)."""

    alpha_raw: torch.Tensor
    beta_raw: torch.Tensor
    z0: torch.Tensor

    event_ndims_in = 1
    event_ndims_out = 1

    @classmethod
    def init(cls, generator, dim: int, dtype=torch.float32, device=None):
        kw = dict(generator=generator, dtype=dtype, device=resolve_device(device))
        return cls(torch.randn((), **kw), torch.randn((), **kw), torch.randn(dim, **kw))

    def _params(self):
        alpha = log1pexp(self.alpha_raw.reshape(()))
        apb = log1pexp(self.beta_raw.reshape(()))  # alpha + beta_hat
        return alpha, apb - alpha, apb

    def forward_and_log_det(self, z):
        alpha, beta_hat, _ = self._params()
        d = self.z0.shape[-1]
        dz = z - self.z0
        r = torch.sqrt(torch.sum(dz * dz, -1))
        h = 1.0 / (alpha + r)
        y = z + (beta_hat * h)[..., None] * dz
        ld = (d - 1) * torch.log1p(beta_hat * h) + torch.log1p(beta_hat * h - beta_hat * h * h * r)
        return y, ld

    def inverse(self, y):
        alpha, _, apb = self._params()
        dy = y - self.z0
        gamma = torch.sqrt(torch.sum(dy * dy, -1))
        a = apb - gamma
        r = 0.5 * (torch.sqrt(a * a + 4.0 * alpha * gamma) - a)
        return self.z0 + ((alpha + r) / (apb + r))[..., None] * dy
