"""Stick-breaking simplex bijector, PyTorch counterpart of
`tpu_bijectors/bijectors/simplex.py`.

Math (0-based k, eps = machine epsilon of the dtype; reference
src/bijectors/simplex.jl:28-138):

  forward:  s_k = sum_{i<k} x_i
            z_0 = x_0 * (1-2eps) + eps
            z_k = (x_k + eps) * (1-2eps) / ((1+eps) - s_k),   k >= 1
            y_k = logit(z_k) + log(K-1-k)
  inverse:  the same recurrence in the running sum, clamped per step
            (simplex.jl:84-100).

Each direction is a `torch.autograd.Function` whose forward is a wrapper
of `kernels/simplex.py` (the CUDA kernel for a CUDA tensor, the plain
version there for a CPU tensor) and whose backward is a closed-form
vector-Jacobian product in torch ops on either device, and whose `jvp`
(forward mode) is the closed-form tangent of the JAX package's jvp rules:

  inverse with its log-det (and the Dirichlet data term wlog):
      `simplex_inverse_logdet`; backward `_simplex_vjp` + `_ld_vjp`
  inverse, x alone:            `simplex_inverse`; backward `_simplex_vjp`
  forward with its log-det:    `simplex_forward_logdet`; backward
      `_simplex_forward_vjp` + `_ld_vjp`

The tangents: `_simplex_inverse_tangent` (the affine running-sum tangent,
by `kernels/simplex.py::affine_scan`), `_simplex_forward_tangent`, and the
log-det's as its gradient `_ld_vjp(x, s, 1)` dotted with dx.

Any leading batch axes are flattened into the kernel's batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from ..kernels.simplex import (
    _exclusive_prefix,
    affine_scan,
    _first,
    _log_km1_minus_k,
    simplex_forward_logdet,
    simplex_inverse,
    simplex_inverse_logdet,
)
from ..utils import _eps, clamp_slope, logistic, max_slope
from .base import Bijector


@dataclass(frozen=True)
class SimplexBijector(Bijector):
    """K-simplex -> R^{K-1} via stick-breaking (reference SimplexBijector)."""

    event_ndims_in = 1
    event_ndims_out = 1

    def forward_event_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def inverse_event_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def forward_and_log_det(self, x):
        """(y, forward log-det) in one pass; `forward` keeps y."""
        if x.shape[-1] < 2:
            raise ValueError("simplex dimension must be >= 2")
        lead = x.shape[:-1]
        y, ld = _SimplexForward.apply(x.reshape(-1, x.shape[-1]))
        return y.reshape(lead + (y.shape[-1],)), ld.reshape(lead)

    def inverse(self, y):
        """x alone: the recurrence without the log-det."""
        lead = y.shape[:-1]
        x = _SimplexInverseX.apply(y.reshape(-1, y.shape[-1]))
        return x.reshape(lead + (x.shape[-1],))

    def inverse_and_log_det(self, y):
        x, ld, _ = _simplex_inverse_logdet_wlog(y, None)
        return x, ld


def _ld_vjp(x, s, gld):
    """Cotangent of x (..., K) from the inverse log-det ld(x) (minus the
    forward log-det) given its cotangent gld (...,): the transpose of the
    JAX package's
    jvp of `_ld_from_x` (bijectors/simplex.py:182, :363), with
    `torch.maximum`'s slopes."""
    K = x.shape[-1]
    eps = _eps(x.dtype)
    k0 = _first(K - 1, x.device)
    xk = x[..., : K - 1]
    u = 1.0 - s
    rem = torch.clamp_min(u, eps)
    zl = torch.where(k0, xk, xk / rem)
    # d ld / d zl, per coordinate
    a = max_slope(zl, eps) / torch.clamp_min(zl, eps) - max_slope(
        1.0 - zl, eps
    ) / torch.clamp_min(1.0 - zl, eps)
    g = gld[..., None]
    gxk = g * torch.where(k0, a, a / rem)
    # rem_k enters through zl = x_k / rem_k and log(rem_k) (k >= 1)
    grem = g * torch.where(k0, torch.zeros_like(a), 1.0 / rem - a * xk / (rem * rem))
    gs = -max_slope(u, eps) * grem
    # s_k = sum_{i<k} x_i: x_i gets the sum of gs_k over k > i
    rev = torch.flip(torch.cumsum(torch.flip(gs, (-1,)), dim=-1), (-1,))
    gxk = gxk + (rev - gs)
    return torch.cat([gxk, torch.zeros_like(x[..., :1])], dim=-1)


@lru_cache(maxsize=None)
def _tri(K: int, device):
    """(K, K-1) mask of l >= j and (K, K) mask of i > j, made once."""
    j = torch.arange(K, device=device)[:, None]
    return j <= torch.arange(K - 1, device=device), j < torch.arange(K, device=device)


def _simplex_vjp(y, x, gx):
    """d<gx, x(y)>/dy for x = kernels/simplex.py::simplex_inverse_plain(y)
    (rows of y (N, K-1)): the
    transpose of the affine running-sum tangent `_simplex_inverse_tangent`
    (tpu_bijectors/bijectors/simplex.py:132-179), with the clamp slopes of
    the forward's clamps.

    x_k = clamp(pre_k) moves with s_k by ds_k = -m_k z_k / c12 (k >= 1) and
    with z_k by dz_k; s_{k+1} = s_k + x_k. So the adjoint of the running
    sum runs backwards as gs_k = gs_{k+1} (1 + ds_k) + gx_k ds_k from
    gs_{K-1} = -m_last gx_{K-1}; unrolled, gs_j = sum_{i >= j} c_i
    prod_{j <= l < i} (1 + ds_l) with c = (gx_k ds_k ..., gs_{K-1}): one
    masked cumulative product and one small batched product, not a loop
    over K."""
    N, K = x.shape
    eps = _eps(x.dtype)
    c12 = 1 - 2 * eps
    z = logistic(y - _log_km1_minus_k(K, y))
    s = _exclusive_prefix(x, K)
    k0 = _first(K - 1, x.device)
    pre = torch.where(k0, (z - eps) / c12, ((1 + eps) - s) / c12 * z - eps)
    m = clamp_slope(pre)
    ds = torch.where(k0, torch.zeros_like(z), -m * z / c12)
    dz = m * torch.where(k0, torch.full_like(s, 1.0 / c12), ((1 + eps) - s) / c12)
    g_last = -clamp_slope(1.0 - (s[:, -1] + x[:, K - 2])) * gx[:, K - 1]
    tail, upper = _tri(K, x.device)
    # T[j, i] = prod_{j <= l < i} (1 + ds_l) for i > j, 1 at i = j, 0 below
    C = torch.cumprod(torch.where(tail, (1.0 + ds)[:, None, :], 1.0), dim=-1)
    T = torch.where(upper, torch.nn.functional.pad(C, (1, 0)), 0.0) + torch.eye(
        K, dtype=x.dtype, device=x.device
    )
    c = torch.cat([gx[:, : K - 1] * ds, g_last[:, None]], dim=-1)
    gs = (T @ c[:, :, None])[:, 1:, 0]  # adjoint of s_{k+1}, k = 0..K-2
    return (gx[:, : K - 1] + gs) * dz * z * (1.0 - z)


def _simplex_forward_vjp(x, gy):
    """d<gy, y(x)>/dx for the forward link y(x) of
    kernels/simplex.py::simplex_forward_logdet_plain (rows of x (N, K)):
    the transpose of its tangent, the jvp of the JAX
    package's closed-form forward. With den_k = (1+eps) - s_k,

      dy_k = (1/z_k + 1/(1 - z_k)) dz_k,
      dz_0 = (1-2eps) dx_0,  dz_k = ((1-2eps) dx_k + z_k ds_k) / den_k,

    and s_k = sum_{i<k} x_i hands each x_i the sum of the ds_k cotangents
    over k > i. x_{K-1} does not enter y."""
    K = x.shape[-1]
    eps = _eps(x.dtype)
    c12 = 1 - 2 * eps
    s = _exclusive_prefix(x, K)
    xk = x[..., : K - 1]
    k0 = _first(K - 1, x.device)
    den = (1 + eps) - s
    z = torch.where(k0, xk * c12 + eps, (xk + eps) * c12 / den)
    gz = gy * (1.0 / z + 1.0 / (1.0 - z))
    gxk = gz * torch.where(k0, torch.full_like(den, c12), c12 / den)
    gs = torch.where(k0, torch.zeros_like(z), gz * z / den)
    rev = torch.flip(torch.cumsum(torch.flip(gs, (-1,)), dim=-1), (-1,))
    gxk = gxk + (rev - gs)
    return torch.cat([gxk, torch.zeros_like(x[..., :1])], dim=-1)


def _simplex_inverse_tangent(y, x, dy):
    """dx of x(y) along dy (rows of y (N, K-1)), given x: the JAX
    package's `_simplex_inverse_tangent`. The running sum's tangent is
    affine, ds_{k+1} = a_k ds_k + b_k with a_k = 1 - m_k z_k/(1-2eps) and
    b_k = m_k ((1+eps) - s_k)/(1-2eps) dz_k (k = 0: a_0 = 1, b_0 = m_0
    dz_0/(1-2eps)), m_k the clamp slopes, so one `affine_scan` solves it;
    dx_k = ds_{k+1} - ds_k and dx_{K-1} = -m_last ds_{K-1}."""
    K = x.shape[-1]
    eps = _eps(x.dtype)
    c12 = 1 - 2 * eps
    z = logistic(y - _log_km1_minus_k(K, y))
    dz = z * (1.0 - z) * dy
    s = _exclusive_prefix(x, K)
    k0 = _first(K - 1, x.device)
    pre = torch.where(k0, (z - eps) / c12, ((1 + eps) - s) / c12 * z - eps)
    m = clamp_slope(pre)
    a = torch.where(k0, torch.ones_like(z), 1.0 - m * z / c12)
    b = m * torch.where(k0, dz / c12, ((1 + eps) - s) / c12 * dz)
    ds = affine_scan(a, b)  # ds[..., k] = ds_{k+1}
    dxk = ds - torch.cat([torch.zeros_like(ds[..., :1]), ds[..., :-1]], dim=-1)
    dx_last = -clamp_slope(1.0 - (s[..., -1] + x[..., K - 2])) * ds[..., -1]
    return torch.cat([dxk, dx_last[..., None]], dim=-1)


def _ld_tangent(x, s, dx):
    """The inverse log-det's tangent along dx: its gradient `_ld_vjp(x, s,
    1)` dotted with dx."""
    return torch.sum(_ld_vjp(x, s, torch.ones_like(x[..., 0])) * dx, dim=-1)


def _simplex_forward_tangent(x, dx):
    """dy of the forward link y(x) along dx (rows of x (N, K)): dz_0 =
    (1-2eps) dx_0, dz_k = ((1-2eps) dx_k + z_k ds_k) / den_k with ds the
    exclusive prefix sum of dx, dy_k = (1/z_k + 1/(1 - z_k)) dz_k: the
    tangent whose transpose is `_simplex_forward_vjp`."""
    K = x.shape[-1]
    eps = _eps(x.dtype)
    c12 = 1 - 2 * eps
    s = _exclusive_prefix(x, K)
    k0 = _first(K - 1, x.device)
    den = (1 + eps) - s
    xk = x[..., : K - 1]
    z = torch.where(k0, xk * c12 + eps, (xk + eps) * c12 / den)
    ds = _exclusive_prefix(dx, K)
    dz = torch.where(k0, c12 * dx[..., : K - 1], (c12 * dx[..., : K - 1] + z * ds) / den)
    return (1.0 / z + 1.0 / (1.0 - z)) * dz


class _SimplexForward(torch.autograd.Function):
    """(y, forward log-det) of x (N, K). Forward: the kernel on the card,
    the plain forward link on the CPU; backward: the closed forms above."""

    @staticmethod
    def forward(ctx, x):
        y, ld = simplex_forward_logdet(x)
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return y, ld

    @staticmethod
    def jvp(ctx, dx):
        (x,) = ctx.saved_tensors
        s = _exclusive_prefix(x, x.shape[-1])
        return _simplex_forward_tangent(x, dx), -_ld_tangent(x, s, dx)

    @staticmethod
    def backward(ctx, gy, gld):
        (x,) = ctx.saved_tensors
        g = torch.zeros_like(x)
        if gy is not None:
            g = g + _simplex_forward_vjp(x, gy)
        if gld is not None:
            g = g + _ld_vjp(x, _exclusive_prefix(x, x.shape[-1]), -gld)
        return g


class _SimplexInverseX(torch.autograd.Function):
    """x of y (N, K-1), no log-det. Forward: the x-only kernel on the
    card, the plain recurrence on the CPU; backward: `_simplex_vjp`."""

    @staticmethod
    def forward(ctx, y):
        x = simplex_inverse(y)
        ctx.save_for_backward(y, x)
        ctx.save_for_forward(y, x)
        return x

    @staticmethod
    def jvp(ctx, dy):
        y, x = ctx.saved_tensors
        return _simplex_inverse_tangent(y, x, dy)

    @staticmethod
    def backward(ctx, gx):
        y, x = ctx.saved_tensors
        return _simplex_vjp(y, x, gx)


class _SimplexInverse(torch.autograd.Function):
    """(x or None, ld, wlog or None) of y (N, K-1) and the optional weights
    am1 (K,). Forward: the kernel on the card, the plain recurrence on the
    CPU; backward: the closed forms above, on both. x is an output whenever
    it was formed (the wrapper drops it where the caller did not ask for
    it), so that, saved as one, it carries its own derivative into a
    second backward pass: the Hessian through this Function is exact on
    both devices."""

    @staticmethod
    def forward(ctx, y, am1, want_x):
        need_x = want_x or any(ctx.needs_input_grad[:2])
        x, ld, wlog = simplex_inverse_logdet(y, am1, want_x=need_x)
        ctx.save_for_backward(y, x, am1)
        ctx.save_for_forward(y, x, am1)
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return x, ld, wlog

    @staticmethod
    def jvp(ctx, dy, dam1, _):
        """(dx, dld, dwlog) along (dy, dam1): the JAX package's
        `_wlog_tangents`. Where the forward formed no x (neither asked for
        nor needed by a backward), the x-only wrapper forms it here."""
        y, x, am1 = ctx.saved_tensors
        x_out = x
        if x is None:
            x = simplex_inverse(y)
        dx = _simplex_inverse_tangent(y, x, torch.zeros_like(y) if dy is None else dy)
        dld = _ld_tangent(x, _exclusive_prefix(x, x.shape[-1]), dx)
        dwlog = None
        if am1 is not None:
            eps = _eps(x.dtype)
            dwlog = torch.sum(am1 * dx / (x + eps), dim=-1)
            if dam1 is not None:
                dwlog = dwlog + torch.sum(dam1 * torch.log(x + eps), dim=-1)
        return (None if x_out is None else dx), dld, dwlog

    @staticmethod
    def backward(ctx, gx, gld, gwlog):
        y, x, am1 = ctx.saved_tensors
        g = gx if gx is not None else torch.zeros_like(x)
        s = _exclusive_prefix(x, x.shape[-1])
        if gld is not None:
            g = g + _ld_vjp(x, s, gld)
        gam1 = None
        if am1 is not None and gwlog is not None:
            logx = torch.log(x + _eps(x.dtype))
            g = g + gwlog[..., None] * am1 / (x + _eps(x.dtype))
            if ctx.needs_input_grad[1]:
                gam1 = torch.sum(gwlog[..., None] * logx, dim=0)
        gy = _simplex_vjp(y, x, g) if ctx.needs_input_grad[0] else None
        return gy, gam1, None


def _simplex_inverse_logdet_wlog(y, am1, want_x: bool = True):
    """(x or None, inverse log-det, sum_k am1[k] log(x_k + eps) or None when
    am1 is None) over any leading axes of y (..., K-1). The eps-nudge is the
    reference's transformed-path Dirichlet density logpdf(d, x .+ eps)
    (src/Bijectors.jl:253): finite when the clamps saturate x to 0."""
    lead = y.shape[:-1]
    x, ld, wlog = _SimplexInverse.apply(y.reshape(-1, y.shape[-1]), am1, want_x)
    x = x.reshape(lead + (x.shape[-1],)) if want_x else None
    return x, ld.reshape(lead), (None if wlog is None else wlog.reshape(lead))
