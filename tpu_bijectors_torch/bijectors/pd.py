"""Positive-definite matrix bijectors, PyTorch counterpart of
`tpu_bijectors/bijectors/pd.py` (reference src/bijectors/pd.jl).

  PDBijector:          SPD X -> lower-triangular L = chol(X) with its
                       diagonal's log.
  PDVecBijector:       PDBijector, then the triangle packed row by row into
                       K(K+1)/2 slots (pd.jl:36-43, `tril_to_vec`).
  CholeskyVecBijector: a lower factor L (positive diagonal) <-> the same
                       packed vector (log on the diagonal).

  logdetJ of the forward link (pd.jl:23-27, 0-based i):
      -( sum_i (K+1-i) log L_ii + K log 2 )

The forward links are torch ops (the JAX package computes them with jnp).
`PDVecBijector`'s inverse is a `torch.autograd.Function` over
`kernels/pd.py`'s `pd_inverse` (the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor), its backward closed form: dL = (dX + dX')L
plus the factor's own cotangent, kept to the lower triangle, the diagonal
times exp(y). `_pd_logdensity` is a Function over `pd_logdensity` (logJ,
sum y_rr and the Wishart-family trace, X and L never formed), its backward
the affine slopes of logJ and sum y_rr plus the trace's cotangent times
`pd_trace_grad` (a Function whose own backward differentiates the plain
closed form, so a Hessian through the density is exact), in both modes;
C's gradient, where C carries one, is the plain version's. Their
forward-mode `jvp`s: dX = dL L' + L dL' for the inverse; the affine slopes
and the trace gradient (the kernel on the card) dotted with dy, plus the
plain version's tangent in C, for the log-density; the plain trace
gradient's tangent for the trace gradient (the JAX package's jvp rules,
bijectors/pd.py `_pd_inverse_all_pallas_jvp`, `_pd_logdensity_pallas_jvp`,
`_pd_tr_grad_jvp`).
Leading batch axes are flattened into the kernel's batch. Beyond the
kernels' K (kernels/pd.py MAX_K) a CPU tensor takes the plain version, as
the JAX package takes its jnp path there, and any other raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from ..kernels.pd import (
    MAX_K,
    affine_coeffs,
    pd_inverse,
    pd_logdensity,
    pd_logdensity_plain,
    pd_trace_grad,
    pd_trace_grad_plain,
)
from ..utils import (
    cholesky_lower,
    pd_from_lower,
    plain_jvp,
    set_diag,
    tril_to_vec,
    triu_dim_from_length,
    vec_to_tril,
)
from .base import Bijector


def _pd_logdet_from_chol(L):
    """-(sum_i (K+1-i) log L_ii + K log 2), reference pd.jl:23-27."""
    K = L.shape[-1]
    coeff = torch.arange(K + 1, 1, -1, dtype=L.dtype, device=L.device)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return -(torch.sum(coeff * torch.log(d), dim=-1) + K * math.log(2.0))


def _link(X):
    """(lower factor with its diagonal's log, forward log-det) of X."""
    L = cholesky_lower(X)
    Y = set_diag(torch.tril(L), torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
    return Y, _pd_logdet_from_chol(L)


def _unlink(Y):
    """The lower factor from Y: its strict lower triangle, exp on the diagonal."""
    return set_diag(torch.tril(Y), torch.exp(torch.diagonal(Y, dim1=-2, dim2=-1)))


def _pd_inverse_vjp(y, L, gX, glogJ, gL):
    """Cotangent of y (N, P) from (X = LL', logJ, L) given theirs (each may
    be None): gL_total = (gX + gX') L + gL on the lower triangle, the
    diagonal slots times L_rr = exp(y_rr), plus (K+1-r) glogJ there."""
    K = L.shape[-1]
    G = torch.zeros_like(L)
    if gX is not None:
        G = G + (gX + gX.transpose(-1, -2)) @ L
    if gL is not None:
        G = G + gL
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    gy = tril_to_vec(set_diag(G, torch.diagonal(G, dim1=-2, dim2=-1) * d))
    if glogJ is not None:
        gy = gy + affine_coeffs(K, y)[0] * glogJ[:, None]
    return gy


class _PDInverse(torch.autograd.Function):
    """(X, logJ, L) of y (N, K(K+1)/2): `pd_inverse` forward, the closed
    form of `_pd_inverse_vjp` backward."""

    @staticmethod
    def forward(ctx, y, K):
        X, logJ, L = pd_inverse(y, K)
        ctx.save_for_backward(y, L)
        ctx.save_for_forward(y, L)
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return X, logJ, L

    @staticmethod
    def jvp(ctx, dy, _):
        """dL: dy off the diagonal, L_rr dy_rr on it; dX = dL L' + L dL';
        dlogJ = sum_r (K+1-r) dy_rr."""
        y, L = ctx.saved_tensors
        K = L.shape[-1]
        dY = vec_to_tril(dy, 0, K)
        dL = set_diag(dY, torch.diagonal(dY, dim1=-2, dim2=-1) * torch.diagonal(L, dim1=-2, dim2=-1))
        dLLt = dL @ L.transpose(-1, -2)
        return dLLt + dLLt.transpose(-1, -2), torch.sum(affine_coeffs(K, y)[0] * dy, -1), dL

    @staticmethod
    def backward(ctx, gX, glogJ, gL):
        y, L = ctx.saved_tensors
        return _pd_inverse_vjp(y, L, gX, glogJ, gL), None


class _PDTraceGrad(torch.autograd.Function):
    """d trace / d y (N, K(K+1)/2): `pd_trace_grad` forward (the kernel on
    the card, the closed form on the CPU); backward the vector-Jacobian
    product of `pd_trace_grad_plain`, the torch composition, as the JAX
    package takes the tangent of its kernel from the jnp composition
    (`tpu_bijectors/bijectors/pd.py::_pd_tr_grad_jvp`). So a second
    derivative through a Wishart-family density is exact on both devices;
    a third raises."""

    @staticmethod
    def forward(ctx, y, K, C, mode):
        ctx.save_for_backward(y, C)
        ctx.save_for_forward(y, C)
        ctx.K, ctx.mode = K, mode
        return pd_trace_grad(y, K, C, mode)

    @staticmethod
    def jvp(ctx, dy, _K, dC, _mode):
        y, C = ctx.saved_tensors
        (dg,) = plain_jvp(lambda v, c: (pd_trace_grad_plain(v, ctx.K, c, ctx.mode),),
                          (y, C), (dy, dC))
        return dg

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        y, C = ctx.saved_tensors
        with torch.enable_grad():
            yy = y.detach().requires_grad_(True)
            (gy,) = torch.autograd.grad(pd_trace_grad_plain(yy, ctx.K, C, ctx.mode), yy, gg)
        return gy, None, None, None


class _PDLogdensity(torch.autograd.Function):
    """(logJ, sum y_rr, trace) of y (N, K(K+1)/2) and C (K, K):
    `pd_logdensity` forward; backward the affine slopes plus the trace's
    cotangent times `pd_trace_grad`; C's cotangent, where C carries a
    gradient, that of the plain version's trace."""

    @staticmethod
    def forward(ctx, y, K, C, mode):
        ctx.save_for_backward(y, C)
        ctx.save_for_forward(y, C)
        ctx.K, ctx.mode = K, mode
        ctx.set_materialize_grads(False)
        return pd_logdensity(y, K, C, mode)

    @staticmethod
    def jvp(ctx, dy, _K, dC, _mode):
        y, C = ctx.saved_tensors
        coeff, diag = affine_coeffs(ctx.K, y)
        dy = torch.zeros_like(y) if dy is None else dy
        dtr = torch.sum(pd_trace_grad(y, ctx.K, C, ctx.mode) * dy, -1)
        if dC is not None:
            (dtr_c,) = plain_jvp(lambda c: (pd_logdensity_plain(y, ctx.K, c, ctx.mode)[2],),
                                 (C,), (dC,))
            dtr = dtr + dtr_c
        return torch.sum(coeff * dy, -1), torch.sum(diag * dy, -1), dtr

    @staticmethod
    def backward(ctx, glogJ, gsumd, gtr):
        y, C = ctx.saved_tensors
        coeff, diag = affine_coeffs(ctx.K, y)
        gy = torch.zeros_like(y)
        if glogJ is not None:
            gy = gy + coeff * glogJ[:, None]
        if gsumd is not None:
            gy = gy + diag * gsumd[:, None]
        gC = None
        if gtr is not None:
            gy = gy + gtr[:, None] * _PDTraceGrad.apply(y, ctx.K, C, ctx.mode)
            if ctx.needs_input_grad[2]:
                with torch.enable_grad():
                    c = C.detach().requires_grad_(True)
                    (gC,) = torch.autograd.grad(
                        pd_logdensity_plain(y.detach(), ctx.K, c, ctx.mode)[2], c, gtr)
        return gy, None, gC, None


def _pd_inverse_all(y):
    """(X, logJ, L) over any leading axes of y (..., K(K+1)/2)."""
    K = triu_dim_from_length(y.shape[-1])
    lead = y.shape[:-1]
    flat = y.reshape(-1, y.shape[-1])
    if K > MAX_K and flat.device.type != "cpu":
        raise NotImplementedError(
            f"the PD inverse kernel takes K <= {MAX_K}; got K = {K} on {flat.device}"
        )
    X, logJ, L = _PDInverse.apply(flat, K)
    return X.reshape(lead + (K, K)), logJ.reshape(lead), L.reshape(lead + (K, K))


def _pd_logdensity(y, K, C, mode):
    """(logJ, sum y_rr, trace) over any leading axes of y (..., K(K+1)/2),
    1 <= K <= MAX_K."""
    lead = y.shape[:-1]
    outs = _PDLogdensity.apply(y.reshape(-1, y.shape[-1]), K, C, mode)
    return tuple(o.reshape(lead) for o in outs)


@dataclass(frozen=True)
class PDBijector(Bijector):
    """SPD matrix -> lower triangular with log-diagonal (reference PDBijector)."""

    event_ndims_in = 2
    event_ndims_out = 2

    def forward_and_log_det(self, X):
        return _link(X)

    def inverse_and_log_det(self, Y):
        L = _unlink(Y)
        return pd_from_lower(L), -_pd_logdet_from_chol(L)


@dataclass(frozen=True)
class PDVecBijector(Bijector):
    """SPD matrix -> packed vector of length K(K+1)/2 (reference PDVecBijector)."""

    event_ndims_in = 2
    event_ndims_out = 1

    def forward_event_shape(self, shape):
        n = shape[-1]
        return tuple(shape[:-2]) + (n * (n + 1) // 2,)

    def inverse_event_shape(self, shape):
        n = triu_dim_from_length(shape[-1])
        return tuple(shape[:-1]) + (n, n)

    def forward_and_log_det(self, X):
        Y, ld = _link(X)
        return tril_to_vec(Y), ld

    def inverse_and_log_det(self, y):
        return _pd_inverse_all(y)[:2]

    def inverse_and_log_det_with_factor(self, y):
        """(X, logJ, L): also the lower Cholesky factor L of X, on which the
        Wishart-family densities fuse (dists/matrix.py `logpdf_from_factor`)
        instead of re-decomposing X."""
        return _pd_inverse_all(y)


@dataclass(frozen=True)
class CholeskyVecBijector(Bijector):
    """A lower Cholesky factor L (positive diagonal) <-> its packed triangle
    with the diagonal's log (reference src/vector/matrix/posdef.jl:27-51);
    logdetJ = -sum_i log L_ii."""

    event_ndims_in = 2
    event_ndims_out = 1

    def forward_event_shape(self, shape):
        n = shape[-1]
        return tuple(shape[:-2]) + (n * (n + 1) // 2,)

    def inverse_event_shape(self, shape):
        n = triu_dim_from_length(shape[-1])
        return tuple(shape[:-1]) + (n, n)

    def forward_and_log_det(self, L):
        d = torch.diagonal(L, dim1=-2, dim2=-1)
        Y = set_diag(torch.tril(L), torch.log(d))
        return tril_to_vec(Y), -torch.sum(torch.log(d), dim=-1)

    def inverse_and_log_det(self, y):
        Y = vec_to_tril(y)
        d = torch.diagonal(Y, dim1=-2, dim2=-1)
        return set_diag(Y, torch.exp(d)), torch.sum(d, dim=-1)
