"""Stacked: different bijectors on static slices of a vector, PyTorch
counterpart of `tpu_bijectors/bijectors/stacked.py` (reference
src/bijectors/stacked.jl).

The ranges are static (start, length) pairs. Each member sees a slice
view of the input (a link kernel reads it in place through its strides);
a scalar member's elementwise log-det is summed over its slice.
"""

from __future__ import annotations

from dataclasses import field

import torch

from ..utils import sum_last
from .base import Bijector, bijector_dataclass


def _output_ranges(bijectors, ranges_in):
    """The output ranges from each block's output length (reference
    `output_length`, stacked.jl:51-87)."""
    out, ofs = [], 0
    for b, (_, n) in zip(bijectors, ranges_in):
        n_out = n if b.event_ndims_in == 0 else int(b.forward_event_shape((n,))[0])
        out.append((ofs, n_out))
        ofs += n_out
    return tuple(out), ofs


@bijector_dataclass
class Stacked(Bijector):
    """`bijectors[i]` on `x[..., ranges_in[i]]`, the results concatenated
    (reference Stacked)."""

    bijectors: tuple
    ranges_in: tuple  # ((start, length), ...)
    # derived from the two above
    ranges_out: tuple = field(init=False, compare=False)
    length_in: int = field(init=False, compare=False)
    length_out: int = field(init=False, compare=False)

    event_ndims_in = 1
    event_ndims_out = 1

    def __post_init__(self):
        object.__setattr__(self, "bijectors", tuple(self.bijectors))
        ranges_in = tuple((int(s), int(n)) for s, n in self.ranges_in)
        object.__setattr__(self, "ranges_in", ranges_in)
        ranges_out, length_out = _output_ranges(self.bijectors, ranges_in)
        object.__setattr__(self, "ranges_out", ranges_out)
        object.__setattr__(self, "length_in", max((s + n for s, n in ranges_in), default=0))
        object.__setattr__(self, "length_out", length_out)

    @classmethod
    def from_lengths(cls, bijectors, lengths):
        """From contiguous block lengths."""
        ranges, ofs = [], 0
        for n in lengths:
            ranges.append((ofs, int(n)))
            ofs += int(n)
        return cls(tuple(bijectors), tuple(ranges))

    def forward_event_shape(self, shape):
        if shape[-1] != self.length_in:
            raise ValueError(f"Stacked input length {shape[-1]} != {self.length_in}")
        return tuple(shape[:-1]) + (self.length_out,)

    def inverse_event_shape(self, shape):
        if shape[-1] != self.length_out:
            raise ValueError(f"Stacked output length {shape[-1]} != {self.length_out}")
        return tuple(shape[:-1]) + (self.length_in,)

    def _check(self, x, n):
        if x.shape[-1] != n:
            raise ValueError(f"Stacked input length {x.shape[-1]} != expected {n}")

    def _apply(self, x, ranges, method):
        outs, ld = [], None
        for b, (s, n) in zip(self.bijectors, ranges):
            yi, ldi = getattr(b, method)(x[..., s: s + n])
            if b.event_ndims_in == 0:
                ldi = sum_last(ldi, 1)
            outs.append(yi)
            ld = ldi if ld is None else ld + ldi
        return torch.cat(outs, dim=-1), ld

    def forward_and_log_det(self, x):
        self._check(x, self.length_in)
        return self._apply(x, self.ranges_in, "forward_and_log_det")

    def inverse_and_log_det(self, y):
        self._check(y, self.length_out)
        return self._apply(y, self.ranges_out, "inverse_and_log_det")

    def forward(self, x):
        self._check(x, self.length_in)
        return torch.cat([b.forward(x[..., s: s + n])
                          for b, (s, n) in zip(self.bijectors, self.ranges_in)], dim=-1)

    def inverse(self, y):
        self._check(y, self.length_out)
        return torch.cat([b.inverse(y[..., s: s + n])
                          for b, (s, n) in zip(self.bijectors, self.ranges_out)], dim=-1)
