"""Matrix-variate families, PyTorch counterpart of
`tpu_bijectors/dists/matrix.py`: LKJ."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .base import CORRELATION, LeafDistribution

LOG2 = math.log(2.0)


def _lkj_log_normalizer(K: int, eta):
    """log c_K(eta) for the density det(R)^(eta-1) / c_K(eta):

    c_K(eta) = prod_{k=1}^{K-1} 2^{(2 eta - 2 + K - k)(K - k)}
               * B(eta + (K-k-1)/2, eta + (K-k-1)/2)^{K-k}
    (Lewandowski-Kurowicka-Joe 2009)."""
    km = torch.as_tensor(K - np.arange(1, K), dtype=eta.dtype, device=eta.device)
    a = eta + (km - 1.0) / 2.0
    lbeta = 2.0 * torch.lgamma(a) - torch.lgamma(2.0 * a)
    return torch.sum((2.0 * eta - 2.0 + km) * km * LOG2 + km * lbeta)


@dataclass(frozen=True)
class LKJ(LeafDistribution):
    """LKJ(dim, eta) over correlation matrices; density det(R)^(eta-1)/c."""

    dim: int
    eta: object = 1.0

    _params = ("eta",)
    event_ndims = 2

    @property
    def event_shape(self):
        return (self.dim, self.dim)

    def logpdf(self, X):
        L = torch.linalg.cholesky(0.5 * (X + X.transpose(-1, -2)))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        return (self.eta - 1.0) * logdet - _lkj_log_normalizer(self.dim, self.eta)

    def logpdf_from_factor(self, log_diag_w):
        """Density from the log-diagonal of the upper factor W of X = W'W,
        which the VecCorrBijector inverse computes anyway: logdet X =
        2 sum log W_jj. No re-decomposition of X."""
        logdet = 2.0 * torch.sum(log_diag_w, -1)
        return (self.eta - 1.0) * logdet - _lkj_log_normalizer(self.dim, self.eta)

    @property
    def support(self):
        return CORRELATION
