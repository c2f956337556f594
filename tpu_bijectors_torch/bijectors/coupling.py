"""RealNVP-style coupling and its PartitionMask, PyTorch counterparts of
`tpu_bijectors/bijectors/coupling.py` (reference
src/bijectors/coupling.jl). The reference partitions with sparse 0/1
matrix products (coupling.jl:51-134); here partition and combine are
static gathers and scatters.

Coupling(theta, mask): y_1 = theta(x_2)(x_1), x_2 and x_3 pass through
(coupling.jl:206-259); the log-det is the inner bijector's on x_1.
"""

from __future__ import annotations

import torch

from .base import Bijector, bijector_dataclass


def _index(idx, x):
    return torch.as_tensor(idx, dtype=torch.long, device=x.device)


@bijector_dataclass
class PartitionMask:
    """A static three-way partition of a length-n vector (reference
    PartitionMask): idx1 transformed, idx2 the conditioner's inputs, idx3
    passed through. An index set not given is the complement, as the
    reference's constructors make it (coupling.jl:63-117)."""

    n: int
    idx1: tuple
    idx2: tuple = None  # type: ignore[assignment]
    idx3: tuple = None  # type: ignore[assignment]

    def __post_init__(self):
        idx1 = tuple(int(i) for i in self.idx1)
        rest = sorted(set(range(self.n)) - set(idx1))
        if self.idx2 is None and self.idx3 is None:
            idx2, idx3 = tuple(rest), ()
        elif self.idx2 is None:
            idx3 = tuple(int(i) for i in self.idx3)
            idx2 = tuple(i for i in rest if i not in set(idx3))
        else:
            idx2 = tuple(int(i) for i in self.idx2)
            idx3 = (tuple(i for i in rest if i not in set(idx2)) if self.idx3 is None
                    else tuple(int(i) for i in self.idx3))
        object.__setattr__(self, "idx1", idx1)
        object.__setattr__(self, "idx2", idx2)
        object.__setattr__(self, "idx3", idx3)

    def partition(self, x):
        return tuple(x[..., _index(idx, x)] if idx else x[..., :0]
                     for idx in (self.idx1, self.idx2, self.idx3))

    def combine(self, x1, x2, x3):
        batch = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1], x3.shape[:-1])
        dtype = torch.promote_types(torch.promote_types(x1.dtype, x2.dtype), x3.dtype)
        out = x1.new_zeros(tuple(batch) + (self.n,), dtype=dtype)
        for idx, part in ((self.idx1, x1), (self.idx2, x2), (self.idx3, x3)):
            if idx:
                out = out.index_copy(-1, _index(idx, out), part.expand(tuple(batch) + (len(idx),)).to(dtype))
        return out


@bijector_dataclass
class Coupling(Bijector):
    """Coupling layer: b = theta(x_2), y_1 = b(x_1) (reference Coupling).
    `theta` maps the x_2 block to a bijector on the x_1 block: `theta(x2)`,
    or `theta(params, x2)` where `params` (an `nn.Module` or a tuple of
    tensors) holds its trainable parameters."""

    theta: object
    mask: PartitionMask
    params: object = None

    event_ndims_in = 1
    event_ndims_out = 1

    def _inner(self, x2):
        return self.theta(x2) if self.params is None else self.theta(self.params, x2)

    def _apply(self, x, method):
        x1, x2, x3 = self.mask.partition(x)
        b = self._inner(x2)
        y1, ld = getattr(b, method)(x1)
        if b.event_ndims_in == 0:
            ld = torch.sum(ld, dim=-1)
        return self.mask.combine(y1, x2, x3), ld

    def forward_and_log_det(self, x):
        return self._apply(x, "forward_and_log_det")

    def inverse_and_log_det(self, y):
        return self._apply(y, "inverse_and_log_det")
