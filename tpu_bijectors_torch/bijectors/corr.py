"""Correlation-matrix bijectors (LKJ links), PyTorch counterpart of
`tpu_bijectors/bijectors/corr.py`: `VecCorrBijector` (correlation matrix
-> packed vector) and `VecCholeskyBijector` (its Cholesky factor -> the
same packed vector).

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

The inverse (X, logJ, log diag W) and the log-det alone (logJ, log diag
W) are `torch.autograd.Function`s: their forwards are `kernels/lkj.py`'s
wrappers `lkj_inverse` and `lkj_logdet` (the CUDA kernels for a CUDA
tensor, the plain cumulative sums there for a CPU tensor), their backward
the closed forms of `_vec_corr_vjp` and `_logdet_vjp` on both; their
forward-mode `jvp`s the tangent of the plain inverse (as the JAX package
takes `jax.jvp` of its jnp composition) and the closed form
`_logdet_tangent` (the JAX package's `_lkj_logdet_tangent`). The
Cholesky link's log-det alone is `lkj_logdet`'s `chol=True` variant; its
inverse is the factor W itself, formed by the torch cumulative sums (the
JAX package forms it in jnp, outside any kernel).
Any leading batch axes are flattened into the kernel's batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from ..kernels.lkj import (
    _inv_link_chol_lkj_with_logdiag,
    _tri_masks,
    _up_mask,
    lkj_inverse,
    lkj_inverse_plain,
    lkj_logdet,
)
from ..utils import (
    _triu_index_arrays,
    _triu_index_tensors,
    cholesky_upper,
    logcosh,
    plain_jvp,
    triu1_dim_from_length,
    triu_to_vec,
    vec_to_triu,
)
from .base import Bijector


def _link_chol_lkj(W, first_row_atanh: bool = True):
    """Upper Cholesky factor W -> strict-upper unconstrained matrix y
    (corr.jl:293-335): asinh(W / sqrt(remainder)) throughout, or with
    `first_row_atanh` the vector variants' atanh(W) on the first row
    (corr.jl:322; the same value in other floating steps)."""
    K = W.shape[-1]
    up = _up_mask(K, W)
    W = torch.triu(W)
    W2 = W * W
    rev_incl = torch.flip(torch.cumsum(torch.flip(W2, (-2,)), dim=-2), (-2,))
    remainder_sq = rev_incl - W2
    safe_rem = torch.where(up, remainder_sq, torch.ones_like(remainder_sq))
    y = torch.asinh(W / torch.sqrt(safe_rem))
    if first_row_atanh:
        row0 = (torch.arange(K, device=W.device) == 0)[:, None]
        y = torch.where(row0, torch.atanh(torch.clamp(W, -1.0, 1.0)), y)
    return torch.where(up, y, torch.zeros_like(y))


def _logabsdetjac_inv_corr_vec(y):
    """-sum_s (K - i_s) logcosh(y_s), 0-based row i_s (corr.jl:474-483)."""
    K = triu1_dim_from_length(y.shape[-1])
    return -torch.sum(_row_coeff(K, y.dtype, y.device) * logcosh(y), dim=-1)


def _logabsdetjac_inv_chol(y):
    """-sum_s (j_s - i_s + 1) logcosh(y_s): the Cholesky link's per-column
    sums of lr_incl - lc (corr.jl:485-501), telescoped."""
    K = triu1_dim_from_length(y.shape[-1])
    return -torch.sum(_row_coeff(K, y.dtype, y.device, True) * logcosh(y), dim=-1)


@lru_cache(maxsize=None)
def _row_coeff(K, dtype, device, chol=False):
    """The multiplicity of logcosh(y_s) in logJ per packed slot s at 0-based
    (row i, column j): K - i for the vec-corr link (the telescoping of
    corr.jl:474-483), j - i + 1 for the Cholesky variant (corr.jl:485-501).
    Made once."""
    rows, cols = _triu_index_arrays(K, 1)
    return torch.as_tensor(cols - rows + 1 if chol else K - rows, dtype=dtype, device=device)


def _logdet_vjp(y, K, chol, glogJ, glog_diag):
    """Cotangent of y (N, P) from (logJ, log diag W) given theirs (each may
    be None): d logcosh / dy = tanh, so gy = -coeff t glogJ - t glog_diag
    of the slot's column, with t = tanh(y) (the transpose of the JAX
    package's `_lkj_logdet_tangent`)."""
    t = torch.tanh(y)
    gy = torch.zeros_like(y)
    if glogJ is not None:
        gy = gy - _row_coeff(K, y.dtype, y.device, chol) * t * glogJ[..., None]
    if glog_diag is not None:
        gy = gy - t * glog_diag[..., _triu_index_tensors(K, 1, y.device)[1]]
    return gy


def _logdet_tangent(y, dy, K, chol):
    """(dlogJ, dlog diag W) of y (N, P) along dy: with t = tanh(y) dy,
    dlogJ = -sum_s coeff_s t_s and dlog diag W_j = -sum of t over column
    j's slots (the JAX package's `_lkj_logdet_tangent`)."""
    t = torch.tanh(y) * dy
    dlogJ = -torch.sum(_row_coeff(K, y.dtype, y.device, chol) * t, dim=-1)
    cols = _triu_index_tensors(K, 1, y.device)[1]
    dlog_diag = -t.new_zeros(t.shape[:-1] + (K,)).index_add_(-1, cols, t)
    return dlogJ, dlog_diag


def _vec_corr_vjp(y, W, gX, glogJ, glog_diag, gW=None):
    """Closed-form vector-Jacobian product of y (N, P) -> (X = W'W, logJ,
    log diag W, W) given the factor W (N, K, K) and the cotangents (each
    may be None). With t = tanh(y), lc = logcosh(y) and lr_excl the running
    sum before row k of column j:

      gW    = W (gX + gX') + gW, kept to the upper triangle
      gy_kj = gW_kj sech^2(y_kj) exp(lr_excl_kj)
              - t_kj sum_{k<i<=j} gW_ij W_ij
      gy   -= (K - k) t_kj glogJ + t_kj glog_diag_j

    (the logJ and log-diagonal slopes are the vec-corr coefficients of
    corr.py:346-367, `_logdet_vjp`). sech^2 exp(lr_excl) is taken as
    exp(lr_excl - 2 lc), in the log domain, so it underflows to 0 rather
    than forming 0 * inf at 1e10 states."""
    K = W.shape[-1]
    gy = _logdet_vjp(y, K, False, glogJ, glog_diag)
    if gX is not None:
        gW = W @ (gX + gX.transpose(-1, -2)) + (0.0 if gW is None else gW)
    if gW is not None:
        t = torch.tanh(y)
        lc = logcosh(y)
        LC = vec_to_triu(lc, 1, K)
        lr_excl = LC - torch.cumsum(LC, dim=-2)
        gW = gW * _tri_masks(K, y.device)[1]
        P = gW * W
        # sum over i > k of P_ij within column j (P is upper triangular)
        below = torch.flip(torch.cumsum(torch.flip(P, (-2,)), dim=-2), (-2,)) - P
        gY = gW * torch.exp(lr_excl - 2.0 * LC) - vec_to_triu(t, 1, K) * below
        gy = gy + triu_to_vec(gY, 1)
    return gy


class _VecCorrInverse(torch.autograd.Function):
    """(X, logJ, log diag W, W or None) of y (N, K(K-1)/2). Forward: the
    kernel on the card, the plain masked cumulative sums on the CPU;
    backward: the closed form of `_vec_corr_vjp` on both, from the factor
    W that the forward writes when a gradient is needed. W is an output
    (the callers drop it) so that, saved as one, it carries its own
    derivative into a second backward pass: the Hessian through this
    Function is exact on both devices."""

    @staticmethod
    def forward(ctx, y, K):
        X, logJ, log_diag, W = lkj_inverse(y, K, want_w=ctx.needs_input_grad[0])
        ctx.save_for_backward(y, W)
        ctx.save_for_forward(y)
        ctx.K = K
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return X, logJ, log_diag, W

    @staticmethod
    def jvp(ctx, dy, _):
        (y,) = ctx.saved_tensors
        dX, dlogJ, dlog_diag, dW = plain_jvp(
            lambda v: lkj_inverse_plain(v, ctx.K, want_w=True), (y,), (dy,))
        return dX, dlogJ, dlog_diag, (dW if ctx.needs_input_grad[0] else None)

    @staticmethod
    def backward(ctx, gX, glogJ, glog_diag, gW):
        y, W = ctx.saved_tensors
        return _vec_corr_vjp(y, W, gX, glogJ, glog_diag, gW), None


class _LkjLogdet(torch.autograd.Function):
    """(logJ, log diag W) of y (N, K(K-1)/2), X never formed. Forward: the
    log-det kernel on the card, the plain cumulative sums on the CPU;
    backward: `_logdet_vjp` on both (it needs y alone)."""

    @staticmethod
    def forward(ctx, y, K, chol):
        logJ, log_diag = lkj_logdet(y, K, chol)
        ctx.save_for_backward(y)
        ctx.save_for_forward(y)
        ctx.K, ctx.chol = K, chol
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return logJ, log_diag

    @staticmethod
    def jvp(ctx, dy, _K, _chol):
        (y,) = ctx.saved_tensors
        return _logdet_tangent(y, dy, ctx.K, ctx.chol)

    @staticmethod
    def backward(ctx, glogJ, glog_diag):
        (y,) = ctx.saved_tensors
        return _logdet_vjp(y, ctx.K, ctx.chol, glogJ, glog_diag), None, None


def _lkj_logdet_all(y, chol: bool):
    """(logJ, log diag W) over any leading axes of y (..., K(K-1)/2), X
    never formed: the vec-corr inverse link's, or with `chol` the
    Cholesky link's (the JAX package's `_chol_logdet_pallas`, which
    LKJCholesky's linked density reaches)."""
    K = triu1_dim_from_length(y.shape[-1])
    lead = y.shape[:-1]
    logJ, log_diag = _LkjLogdet.apply(y.reshape(-1, y.shape[-1]), K, chol)
    return logJ.reshape(lead), log_diag.reshape(lead + (K,))


def _vec_corr_inverse_all(y):
    """(X, logJ, log diag W) over any leading axes of y (..., K(K-1)/2)."""
    K = triu1_dim_from_length(y.shape[-1])
    lead = y.shape[:-1]
    X, logJ, log_diag, _ = _VecCorrInverse.apply(y.reshape(-1, y.shape[-1]), K)
    return X.reshape(lead + (K, K)), logJ.reshape(lead), log_diag.reshape(lead + (K,))


@dataclass(frozen=True)
class CorrBijector(Bijector):
    """Correlation matrix -> strict-upper-triangular unconstrained matrix
    (reference CorrBijector, corr.jl:64-92). The inverse packs Y's strict
    upper triangle in `VecCorrBijector`'s order and runs its link Function
    (#6 on the card, the plain cumulative sums on the CPU), with its
    closed-form backward, `jvp` and second derivative. That logJ already
    holds the sum_{j>=1} (K-1-j) log W_jj term of corr.jl:74-81."""

    event_ndims_in = 2
    event_ndims_out = 2

    def forward(self, X):
        return _link_chol_lkj(cholesky_upper(X), first_row_atanh=False)

    def forward_and_log_det(self, X):
        y = self.forward(X)
        return y, -self.inverse_log_det_jacobian(y)

    def inverse_and_log_det(self, Y):
        return _vec_corr_inverse_all(triu_to_vec(Y, 1))[:2]

    def inverse_log_det_jacobian(self, Y):
        """-sum_{i<j} (K - i) logcosh(Y_ij), 0-based row i (corr.jl:464-472)."""
        return _logabsdetjac_inv_corr_vec(triu_to_vec(Y, 1))


@dataclass(frozen=True)
class VecCorrBijector(Bijector):
    """Correlation matrix -> packed vector of length K(K-1)/2 (reference
    VecCorrBijector, corr.jl:95-162)."""

    event_ndims_in = 2
    event_ndims_out = 1

    def forward_event_shape(self, shape):
        n = shape[-1]
        return tuple(shape[:-2]) + (n * (n - 1) // 2,)

    def inverse_event_shape(self, shape):
        n = triu1_dim_from_length(shape[-1])
        return tuple(shape[:-1]) + (n, n)

    def forward(self, X):
        return triu_to_vec(_link_chol_lkj(cholesky_upper(X)), k=1)

    def forward_and_log_det(self, X):
        y = self.forward(X)
        return y, -_logabsdetjac_inv_corr_vec(y)

    def inverse_and_log_det(self, y):
        return _vec_corr_inverse_all(y)[:2]

    def inverse_and_log_det_with_factor(self, y):
        """(X, logJ, log diag W): the log-diagonal of the factor W of X that
        the inverse computes anyway, on which the LKJ density fuses
        (matrix.py LKJ.logpdf_from_factor) instead of re-decomposing X."""
        return _vec_corr_inverse_all(y)

    def inverse_log_det_and_factor_only(self, y):
        """(logJ, log diag W) without materialising X: the LKJ density
        needs only the factor's diagonal (matrix.py LKJ.logpdf_from_factor)."""
        return _lkj_logdet_all(y, False)

    def inverse_log_det_and_factor_only_t(self, yT):
        """The same on the transposed (P, B) block of a state, read in place
        (the kernel takes the swapped view through its strides); log diag W
        comes back (B, K)."""
        return _lkj_logdet_all(yT.transpose(0, 1), False)


@dataclass(frozen=True)
class VecCholeskyBijector(Bijector):
    """Cholesky factor of a correlation matrix -> packed vector of length
    K(K-1)/2 (reference VecCholeskyBijector, corr.jl:164-259). mode 'U':
    the factor is upper triangular (X = W), 'L': lower (X = W')."""

    mode: str = "U"

    event_ndims_in = 2
    event_ndims_out = 1

    def __post_init__(self):
        if self.mode not in ("U", "L"):
            raise ValueError("mode must be 'U' or 'L'")

    def forward_event_shape(self, shape):
        n = shape[-1]
        return tuple(shape[:-2]) + (n * (n - 1) // 2,)

    def inverse_event_shape(self, shape):
        n = triu1_dim_from_length(shape[-1])
        return tuple(shape[:-1]) + (n, n)

    def _factor(self, W):
        return W if self.mode == "U" else W.transpose(-1, -2)

    def forward(self, X):
        return triu_to_vec(_link_chol_lkj(self._factor(X)), k=1)

    def forward_and_log_det(self, X):
        y = self.forward(X)
        return y, -_logabsdetjac_inv_chol(y)

    def inverse_and_log_det_with_factor(self, y):
        """(X, logJ, log diag W): the sample is the factor, so this also
        gives its log-diagonal, from the running sums (finite at 1e10
        states, where the diagonal underflows to 0), for
        LKJCholesky.logpdf_from_factor."""
        K = triu1_dim_from_length(y.shape[-1])
        W, logJ, log_diag = _inv_link_chol_lkj_with_logdiag(vec_to_triu(y, 1, K))
        return self._factor(W), logJ, log_diag

    def inverse_and_log_det(self, y):
        return self.inverse_and_log_det_with_factor(y)[:2]

    def inverse_log_det_and_factor_only(self, y):
        """(logJ, log diag W) without forming the factor: the LKJ log-det
        kernel's Cholesky variant (`chol=True`)."""
        return _lkj_logdet_all(y, True)

    def inverse_log_det_and_factor_only_t(self, yT):
        """The same on the transposed (P, B) block, read in place."""
        return _lkj_logdet_all(yT.transpose(0, 1), True)
