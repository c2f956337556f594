"""Autoregressive neural spline flow (NSF-AR; Durkan et al. 2019), PyTorch
counterpart of `tpu_bijectors/flows/nsf.py`: the MADE-masked one-pass
conditioner of maf.py emitting per-coordinate rational-quadratic-spline
tables (rqs.py), so one layer fits multimodal marginals.

- `forward` is one masked-matmul pass producing every spline table, then
  the comparison-count spline, over the leading axes;
- `inverse` is D fixed-point passes (pass i settles coordinate i
  exactly, as MAF's), each the closed-form RQS inverse;
- identity at init: the derivative raws are biased by softplus^-1(1), so
  zero head weights give unit-slope uniform-knot splines (the identity on
  [-B, B]).
"""

from __future__ import annotations

import math

import torch

from ..bijectors.base import Bijector, Chain, bijector_dataclass
from ..utils import resolve_device
from .maf import _as_mask, _made_masks, _masked_mlp_hidden, reversing_stack
from .rqs import RationalQuadraticSpline

_SOFTPLUS_INV_1 = math.log(math.e - 1.0)  # log1pexp(x) = 1  <=>  x = log(e - 1)


@bijector_dataclass
class MaskedAutoregressiveSpline(Bijector):
    """One NSF-AR layer: y_i = RQS(theta_i(x_<i))(x_i), the identity outside
    [-B, B]. Trainable: the masked-MLP weights."""

    w1: torch.Tensor  # (hidden, dim)
    b1: torch.Tensor  # (hidden,)
    w2: torch.Tensor  # (dim * (3K-1), hidden), rows masked per output coordinate
    b2: torch.Tensor  # (dim * (3K-1),)
    mask1: torch.Tensor  # (hidden, dim)
    mask2: torch.Tensor  # (dim, hidden), repeated over each coordinate's 3K-1 rows
    n_bins: int = 8
    B: float = 4.0

    event_ndims_in = 1
    event_ndims_out = 1
    constant_fields = ("mask1", "mask2")

    def __post_init__(self):
        object.__setattr__(self, "mask1", _as_mask(self.mask1, self.w1))
        object.__setattr__(self, "mask2", _as_mask(self.mask2, self.w1))

    @classmethod
    def init(cls, generator, dim: int, n_bins: int = 8, hidden: int | None = None,
             B: float = 4.0, dtype=torch.float32, device=None):
        hidden = hidden or max(2 * dim, 16)
        m1, m2 = _made_masks(dim, hidden)
        kw = dict(generator=generator, dtype=dtype, device=resolve_device(device))
        p = 3 * n_bins - 1
        w1 = 0.1 * torch.randn((hidden, dim), **kw)
        # a small head: the spline tables start near the identity's
        w2 = 0.01 * torch.randn((dim * p, hidden), **kw)
        zeros = dict(dtype=dtype, device=w1.device)
        return cls(w1, torch.zeros(hidden, **zeros), w2, torch.zeros(dim * p, **zeros),
                   m1, m2, n_bins, B)

    def _spline(self, x):
        """One conditioner pass: the per-coordinate splines, parameters
        (..., dim, K) rows."""
        K = self.n_bins
        dim = self.mask2.shape[0]
        h = _masked_mlp_hidden(x, self.w1, self.b1, self.mask1)
        m2_rep = torch.repeat_interleave(self.mask2.to(x.dtype), 3 * K - 1, dim=0)
        raw = (h @ (self.w2 * m2_rep).T + self.b2).reshape(tuple(x.shape[:-1]) + (dim, 3 * K - 1))
        return RationalQuadraticSpline(raw[..., :K], raw[..., K:2 * K],
                                       raw[..., 2 * K:] + _SOFTPLUS_INV_1, self.B)

    def forward_and_log_det(self, x):
        y, ld = self._spline(x).forward_and_log_det(x)
        return y, torch.sum(ld, -1)

    def inverse_and_log_det(self, y):
        x = torch.zeros_like(y)
        for _ in range(self.mask2.shape[0]):
            x = self._spline(x).inverse(y)
        _, ld = self._spline(x).forward_and_log_det(x)
        return x, -torch.sum(ld, -1)


def nsf_ar_stack(generator, dim: int, n_layers: int = 3, n_bins: int = 8,
                 hidden: int | None = None, B: float = 4.0, dtype=torch.float32,
                 device=None) -> Chain:
    """NSF-AR layers with coordinate-reversing Permutes between them (as
    maf_stack). Forward is the fast direction; wrap in `Invert` to fit
    data by maximum likelihood."""
    return reversing_stack([
        MaskedAutoregressiveSpline.init(generator, dim, n_bins, hidden, B, dtype, device)
        for _ in range(n_layers)])
