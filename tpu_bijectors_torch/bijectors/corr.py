"""Correlation-matrix bijector (LKJ link), PyTorch counterpart of
`tpu_bijectors/bijectors/corr.py` (`VecCorrBijector`, plain path only).

Every recurrence of the reference's per-column loops (corr.jl:293-399) is a
masked cumulative sum along the row axis:

  forward link (corr.jl:293-335): W = chol_upper(X);
      remainder_sq[i,j] = sum_{k>i} W[k,j]^2
      y = asinh(W / sqrt(remainder_sq)) on the strict upper triangle,
      atanh(W[0,j]) on the first row (corr.jl:322)
  inverse link (corr.jl:344-399): z = tanh(y), lc = logcosh(y);
      lr_incl[i,j] = -sum_{k<=i} lc[k,j],  lr_excl = lr_incl + lc
      W[i,j] = z[i,j] exp(lr_excl[i,j]) (i<j),  W[j,j] = exp(lr_incl[j-1,j])

Packing is column-major over the strict upper triangle (src/utils.jl:77-85).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import (
    _triu_index_arrays,
    cholesky_upper,
    logcosh,
    pd_from_upper,
    triu1_dim_from_length,
    triu_to_vec,
    vec_to_triu,
)
from .base import Bijector


def _up_mask(K, like):
    return torch.triu(torch.ones(K, K, dtype=torch.bool, device=like.device), 1)


def _link_chol_lkj(W):
    """Upper Cholesky factor W -> strict-upper unconstrained matrix y, with
    the vector variant's atanh first row (corr.jl:293-335)."""
    K = W.shape[-1]
    up = _up_mask(K, W)
    W = torch.triu(W)
    W2 = W * W
    rev_incl = torch.flip(torch.cumsum(torch.flip(W2, (-2,)), dim=-2), (-2,))
    remainder_sq = rev_incl - W2
    safe_rem = torch.where(up, remainder_sq, torch.ones_like(remainder_sq))
    y = torch.asinh(W / torch.sqrt(safe_rem))
    row0 = (torch.arange(K, device=W.device) == 0)[:, None]
    y = torch.where(row0, torch.atanh(torch.clamp(W, -1.0, 1.0)), y)
    return torch.where(up, y, torch.zeros_like(y))


def _inv_link_chol_lkj_with_logdiag(Y):
    """(W, logJ, log diag W) from the strict-upper y-matrix. The
    log-diagonal comes straight from the running sums, never log(exp(.)):
    at |y| ~ 1e10 the diagonal underflows to 0 and its log would be -inf."""
    K = Y.shape[-1]
    up = _up_mask(K, Y)
    zero = torch.zeros_like(Y)
    Yu = torch.where(up, Y, zero)
    z = torch.where(up, torch.tanh(Yu), zero)
    lc = torch.where(up, logcosh(Yu), zero)
    lr_incl = -torch.cumsum(lc, dim=-2)
    lr_excl = lr_incl + lc
    W_off = z * torch.exp(lr_excl)
    diag_lr = torch.cat(
        [
            Y.new_zeros(Y.shape[:-2] + (1,)),
            torch.diagonal(lr_incl[..., :-1, 1:], dim1=-2, dim2=-1),
        ],
        dim=-1,
    )
    W = torch.where(up, W_off, zero)
    W = W + torch.exp(diag_lr)[..., None, :] * torch.eye(
        K, dtype=Y.dtype, device=Y.device
    )
    logJ = torch.sum(torch.where(up, lr_incl, zero), dim=(-2, -1))
    logJ = logJ + torch.sum(diag_lr, dim=-1)
    return W, logJ, diag_lr


def _logabsdetjac_inv_corr_vec(y):
    """-sum_s (K - i_s) logcosh(y_s), 0-based row i_s (corr.jl:474-483)."""
    K = triu1_dim_from_length(y.shape[-1])
    rows, _ = _triu_index_arrays(K, 1)
    coeff = torch.as_tensor(K - rows, dtype=y.dtype, device=y.device)
    return -torch.sum(coeff * logcosh(y), dim=-1)


def _diag_coeff(K, like):
    # corr.jl:74-81: logJ += sum_j (K-1-j) log W[j,j] for j >= 1 (0-based)
    c = np.concatenate([[0.0], np.maximum(np.arange(K - 2, -1, -1), 0)])
    return torch.as_tensor(c, dtype=like.dtype, device=like.device)


def _vec_corr_logdet(y):
    """(logJ, log diag W) without forming X."""
    K = triu1_dim_from_length(y.shape[-1])
    _, logJ, log_diag = _inv_link_chol_lkj_with_logdiag(vec_to_triu(y, 1, K))
    return logJ + torch.sum(_diag_coeff(K, y) * log_diag, dim=-1), log_diag


def _vec_corr_inverse_all(y):
    """(X, logJ, log diag W)."""
    K = triu1_dim_from_length(y.shape[-1])
    W, logJ, log_diag = _inv_link_chol_lkj_with_logdiag(vec_to_triu(y, 1, K))
    logJ = logJ + torch.sum(_diag_coeff(K, y) * log_diag, dim=-1)
    return pd_from_upper(W), logJ, log_diag


@dataclass(frozen=True)
class VecCorrBijector(Bijector):
    """Correlation matrix -> packed vector of length K(K-1)/2 (reference
    VecCorrBijector, corr.jl:95-162)."""

    event_ndims_in = 2
    event_ndims_out = 1

    def forward_event_shape(self, shape):
        n = shape[-1]
        return tuple(shape[:-2]) + (n * (n - 1) // 2,)

    def forward(self, X):
        return triu_to_vec(_link_chol_lkj(cholesky_upper(X)), k=1)

    def forward_and_log_det(self, X):
        y = self.forward(X)
        return y, -_logabsdetjac_inv_corr_vec(y)

    def inverse_and_log_det(self, y):
        return _vec_corr_inverse_all(y)[:2]

    def inverse_log_det_and_factor_only(self, y):
        """(logJ, log diag W) without materialising X: the LKJ density
        needs only the factor's diagonal (matrix.py LKJ.logpdf_from_factor)."""
        return _vec_corr_logdet(y)
