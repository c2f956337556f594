"""Rational-quadratic spline bijector (neural spline flows), PyTorch
counterpart of `tpu_bijectors/flows/rqs.py` (reference
rational_quadratic_spline.jl; Durkan et al. 2019). Monotone RQ spline on
[-B, B], the identity outside; closed-form inverse by the quadratic
(eq. 24-27).

The bin of a value is the JAX package's branch-free comparison count
(the number of knots at or below it, less one, clipped inside), not
`torch.searchsorted`: at a knot the two differ, and the count's rule is
the one the JAX package keeps. Knots broadcast against the values over
any leading layout (per-event rows (d, K+1), per-sample tables
(..., d, K+1) from a conditioner).

Parameterization (rqs.jl:99-123), from raw widths w, heights h (..., K)
and derivatives d (..., K-1):
  knots_x = cumsum([0, softmax(w)]) * 2B - B   (K+1 knots; likewise y)
  derivs  = [1, log1pexp(d), 1]                (unit slopes at the ends)
"""

from __future__ import annotations

import torch

from ..bijectors.base import Bijector, bijector_dataclass
from ..utils import log1pexp, resolve_device


def _knots(raw, B):
    c = torch.cumsum(torch.softmax(raw, dim=-1), dim=-1) * (2.0 * B) - B
    return torch.cat([torch.full_like(c[..., :1], -B), c], dim=-1)


def _derivs(raw):
    ones = torch.ones_like(raw[..., :1])
    return torch.cat([ones, log1pexp(raw), ones], dim=-1)


def _search_bins(knots, v):
    """0-based bin of v among the knots, clipped to 0 .. K-1."""
    K = knots.shape[-1] - 1
    idx = torch.sum(v[..., None] >= knots, dim=-1) - 1
    return torch.clamp(idx, 0, K - 1)


def _gather(table, idx):
    """table[..., idx] with table (..., K+1) broadcast against idx."""
    shape = torch.broadcast_shapes(idx.shape, table.shape[:-1])
    t = table.expand(tuple(shape) + table.shape[-1:])
    return torch.gather(t, -1, idx.expand(shape)[..., None])[..., 0]


def _rqs_pieces(kx, ky, d, idx):
    w_k = _gather(kx, idx)
    w = _gather(kx, idx + 1) - w_k
    h_k = _gather(ky, idx)
    dy = _gather(ky, idx + 1) - h_k
    return w_k, w, h_k, dy, _gather(d, idx), _gather(d, idx + 1), dy / w


@bijector_dataclass
class RationalQuadraticSpline(Bijector):
    """Elementwise monotone RQ spline (event_ndims 0). `widths`, `heights`:
    raw (..., K); `derivatives`: raw (..., K-1). Parameters with a leading
    dimension of the event's length give each element its own spline (the
    reference's matrix-parameter variant, rqs.jl:173-178), broadcasting
    parameter rows against x's last axis."""

    widths: torch.Tensor
    heights: torch.Tensor
    derivatives: torch.Tensor
    B: float = 3.0

    event_ndims_in = 0
    event_ndims_out = 0
    monotonically_increasing = True

    @classmethod
    def init(cls, generator, K: int, B: float = 3.0, event_dim: int | None = None,
             dtype=torch.float32, device=None):
        kw = dict(generator=generator, dtype=dtype, device=resolve_device(device))
        shape = (K,) if event_dim is None else (event_dim, K)
        dshape = (K - 1,) if event_dim is None else (event_dim, K - 1)
        return cls(0.1 * torch.randn(shape, **kw), 0.1 * torch.randn(shape, **kw),
                   0.1 * torch.randn(dshape, **kw), B)

    def _tables(self):
        return (_knots(self.widths, self.B), _knots(self.heights, self.B),
                _derivs(self.derivatives))

    def forward_and_log_det(self, x):
        kx, ky, d = self._tables()
        inside = (x > -self.B) & (x < self.B)
        xs = torch.where(inside, x, torch.zeros_like(x))
        w_k, w, h_k, dy, d_k, d_k1, s = _rqs_pieces(kx, ky, d, _search_bins(kx, xs))
        xi = (xs - w_k) / w
        om = 1.0 - xi
        denom = s + (d_k1 + d_k - 2.0 * s) * xi * om
        y = h_k + dy * (s * xi * xi + d_k * xi * om) / denom
        num_l = s * s * (d_k1 * xi * xi + 2.0 * s * xi * om + d_k * om * om)
        ld = torch.log(num_l) - 2.0 * torch.log(denom)
        return torch.where(inside, y, x), torch.where(inside, ld, torch.zeros_like(ld))

    def inverse(self, y):
        kx, ky, d = self._tables()
        inside = (y > -self.B) & (y < self.B)
        ys = torch.where(inside, y, torch.zeros_like(y))
        w_k, w, h_k, dy, d_k, d_k1, s = _rqs_pieces(kx, ky, d, _search_bins(ky, ys))
        ds = d_k1 + d_k - 2.0 * s
        r = ys - h_k
        a1 = dy * (s - d_k) + r * ds
        a2 = dy * d_k - r * ds
        a3 = -s * r
        xi = (-2.0 * a3) / (a2 + torch.sqrt(a2 * a2 - 4.0 * a1 * a3))
        return torch.where(inside, xi * w + w_k, y)
