"""Masked autoregressive flow layer (MAF/IAF; Papamakarios et al. 2017,
Kingma et al. 2016) on a MADE-masked conditioner (Germain et al. 2015),
PyTorch counterpart of `tpu_bijectors/flows/maf.py`. One layer computes

    y_i = x_i * exp(s_i(x_<i)) + m_i(x_<i)

with (m, s) from one pass of a weight-masked MLP (the masks make it
strictly autoregressive):

- `forward` (the sampling direction, which ADVI's FlowPosterior uses) is
  one pass of masked matrix products over the leading axes;
- `inverse` (the density direction, for fitting data) is D fixed-point
  passes of the same network: pass i settles coordinate i exactly, so D
  passes invert exactly. Fit data with `Invert(layer)` /
  `Invert(maf_stack(...))` so that the fast pass faces the data.

The log-scale is soft-clamped, s = cap * tanh(s_raw / cap). The masks are
constant tensors (`constant_fields`: `flow_parameters` leaves them out);
the JAX package computes the flows in plain jnp, so these are plain torch
matrix products on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bijectors.base import Bijector, Chain, bijector_dataclass
from ..bijectors.reshape import Permute
from ..utils import resolve_device


def _made_masks(dim: int, hidden: int):
    """MADE degree masks for one hidden layer: hidden unit of degree k sees
    inputs of degree <= k; output of degree i sees hidden units of degree
    < i, so output i depends only on inputs < i. numpy float32 arrays
    (hidden, dim) and (dim, hidden)."""
    deg_in = np.arange(1, dim + 1)
    # hidden degrees cycle through 1 .. dim-1 (dim 1: no dependencies at all)
    deg_hidden = (np.arange(hidden) % max(dim - 1, 1)) + 1
    m1 = (deg_hidden[:, None] >= deg_in[None, :]).astype(np.float32)
    m2 = (deg_in[:, None] > deg_hidden[None, :]).astype(np.float32)
    return m1, m2


def _as_mask(mask, like):
    """A mask (numpy array, nested tuples or tensor) as a constant tensor of
    `like`'s dtype and device."""
    if isinstance(mask, torch.Tensor):
        return mask.detach().to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(mask), dtype=like.dtype, device=like.device)


def _masked_mlp_hidden(x, w1, b1, mask1):
    return torch.tanh(x @ (w1 * mask1.to(x.dtype)).T + b1)


@bijector_dataclass
class MaskedAutoregressive(Bijector):
    """One MAF/IAF layer. Trainable: the masked-MLP weights."""

    w1: torch.Tensor  # (hidden, dim)
    b1: torch.Tensor  # (hidden,)
    wm: torch.Tensor  # (dim, hidden): the shift head
    bm: torch.Tensor  # (dim,)
    ws: torch.Tensor  # (dim, hidden): the log-scale head
    bs: torch.Tensor  # (dim,)
    mask1: torch.Tensor  # (hidden, dim)
    mask2: torch.Tensor  # (dim, hidden)
    scale_cap: float = 3.0

    event_ndims_in = 1
    event_ndims_out = 1
    constant_fields = ("mask1", "mask2")

    def __post_init__(self):
        object.__setattr__(self, "mask1", _as_mask(self.mask1, self.w1))
        object.__setattr__(self, "mask2", _as_mask(self.mask2, self.w1))

    @classmethod
    def init(cls, generator, dim: int, hidden: int | None = None, dtype=torch.float32,
             device=None):
        hidden = hidden or max(2 * dim, 8)
        m1, m2 = _made_masks(dim, hidden)
        kw = dict(generator=generator, dtype=dtype, device=resolve_device(device))
        # small weights: the layer starts near the identity (s = 0, m = 0)
        w1 = 0.1 * torch.randn((hidden, dim), **kw)
        wm = 0.01 * torch.randn((dim, hidden), **kw)
        ws = 0.01 * torch.randn((dim, hidden), **kw)
        zeros = dict(dtype=dtype, device=w1.device)
        return cls(w1, torch.zeros(hidden, **zeros), wm, torch.zeros(dim, **zeros),
                   ws, torch.zeros(dim, **zeros), m1, m2)

    def _nets(self, x):
        h = _masked_mlp_hidden(x, self.w1, self.b1, self.mask1)
        m2 = self.mask2.to(x.dtype)
        m = h @ (self.wm * m2).T + self.bm
        s_raw = h @ (self.ws * m2).T + self.bs
        cap = self.scale_cap
        return m, cap * torch.tanh(s_raw / cap)

    def forward_and_log_det(self, x):
        m, s = self._nets(x)
        return x * torch.exp(s) + m, torch.sum(s, -1)

    def inverse_and_log_det(self, y):
        x = torch.zeros_like(y)
        for _ in range(y.shape[-1]):
            m, s = self._nets(x)
            x = (y - m) * torch.exp(-s)
        _, s = self._nets(x)
        return x, -torch.sum(s, -1)


def flow_stack(generator, dim: int, kind: str = "maf", **kwargs) -> Chain:
    """The autoregressive stacks by kind: 'maf' (affine; the cheapest) or
    'nsf' (spline; fits multimodal marginals). kwargs go to maf_stack or
    nsf_ar_stack."""
    if kind == "maf":
        return maf_stack(generator, dim, **kwargs)
    if kind == "nsf":
        from .nsf import nsf_ar_stack

        return nsf_ar_stack(generator, dim, **kwargs)
    raise ValueError(f"unknown flow kind {kind!r}")


def reversing_stack(layers) -> Chain:
    """`layers` chained with a coordinate-reversing Permute between each
    two, so that every coordinate is conditioned on every other across the
    stack (the first layer innermost, as the JAX package builds it)."""
    dim = layers[0].mask2.shape[0]
    rev = Permute(tuple(range(dim - 1, -1, -1)))
    out = []
    for i, layer in enumerate(layers):
        if i:
            out.append(rev)
        out.append(layer)
    return Chain(tuple(out))


def maf_stack(generator, dim: int, n_layers: int = 4, hidden: int | None = None,
              dtype=torch.float32, device=None) -> Chain:
    """MaskedAutoregressive layers with coordinate-reversing Permutes
    between them. Forward is the fast sampling direction; wrap in `Invert`
    to fit data by maximum likelihood."""
    return reversing_stack([MaskedAutoregressive.init(generator, dim, hidden, dtype, device)
                            for _ in range(n_layers)])
