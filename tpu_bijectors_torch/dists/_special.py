"""Special functions the port's cdfs need and torch lacks.

`betainc(a, b, x)` is the regularized incomplete beta function I_x(a, b)
(the counterpart of `jax.scipy.special.betainc`, which the JAX package's
StudentT cdf calls): the continued fraction of Numerical Recipes' `betacf`
by the modified Lentz method, in float64 whatever the inputs' dtype, with
the symmetry I_x(a, b) = 1 - I_{1-x}(b, a) where x > (a + 1) / (a + b + 2),
the side on which the fraction converges fast. It iterates until every
element has converged, so it is registered as one operator (`tbt::betainc`)
that a trace records as a single node: the traced entries of the fused
evaluation hoist it with the other parameter-only work (a truncation's
normaliser) and decline a leaf that would evaluate it on the state. Its
derivative in x is the beta density; in a and b it has none here.
"""

from __future__ import annotations

import torch

_TINY = 1e-300
_TOL = 1e-16
_MAX_ITER = 10000


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b) (modified Lentz), float64."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = torch.where(d.abs() < _TINY, torch.full_like(d, _TINY), d)
    d = 1.0 / d
    h = d.clone()
    done = torch.zeros_like(x, dtype=torch.bool)
    for m in range(1, _MAX_ITER + 1):
        m2 = 2.0 * m
        step = torch.ones_like(x)
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 + aa * d
            d = torch.where(d.abs() < _TINY, torch.full_like(d, _TINY), d)
            c = 1.0 + aa / c
            c = torch.where(c.abs() < _TINY, torch.full_like(c, _TINY), c)
            d = 1.0 / d
            step = step * (d * c)
        # an element stops at its own convergence: iterating on past it
        # lets rounding drift its product
        h = torch.where(done, h, h * step)
        done = done | ((d * c - 1.0).abs() <= _TOL)
        if bool(torch.all(done)):
            break
    return h


@torch.library.custom_op("tbt::betainc", mutates_args=())
def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """I_x(a, b) for a, b > 0, broadcast; 0 at x <= 0 and 1 at x >= 1."""
    dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype), x.dtype)
    a, b, x = torch.broadcast_tensors(a.double(), b.double(), x.double())
    inside = (x > 0.0) & (x < 1.0)
    xc = torch.where(inside, x, torch.full_like(x, 0.5))
    swap = xc > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - xc, xc)
    lbt = (torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
           + aa * torch.log(xx) + bb * torch.log1p(-xx))
    front = torch.exp(lbt) * _betacf(aa, bb, xx) / aa
    out = torch.where(swap, 1.0 - front, front)
    out = torch.where(inside, out, (x >= 1.0).double())
    return out.to(dtype)


@betainc.register_fake
def _(a, b, x):
    shape = torch.broadcast_shapes(a.shape, b.shape, x.shape)
    dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype), x.dtype)
    return x.new_empty(shape, dtype=dtype)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad):
    a, b, x = ctx.saved_tensors
    lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    dens = torch.exp((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - lbeta)
    dens = torch.where((x > 0.0) & (x < 1.0), dens, torch.zeros_like(dens))
    gx = grad * dens
    if gx.shape != x.shape:
        gx = gx.sum_to_size(x.shape)
    return None, None, gx


betainc.register_autograd(_backward, setup_context=_setup)
