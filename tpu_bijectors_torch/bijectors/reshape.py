"""Reshape and Permute, PyTorch counterparts of
`tpu_bijectors/bijectors/reshape.py` (reference src/bijectors/reshape.jl
and permute.jl). Permute is a static gather along the event axis, not the
reference's sparse matrix product (permute.jl:84-153); both are plain
torch on either device, as the JAX package computes them in jnp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Bijector, bijector_dataclass


@bijector_dataclass
class Reshape(Bijector):
    """A pure reshape of the event, log|J| = 0 (reference reshape.jl:20-29)."""

    shape_in: tuple
    shape_out: tuple

    def __post_init__(self):
        object.__setattr__(self, "shape_in", tuple(int(s) for s in self.shape_in))
        object.__setattr__(self, "shape_out", tuple(int(s) for s in self.shape_out))
        if math.prod(self.shape_in) != math.prod(self.shape_out):
            raise ValueError(f"element count mismatch: {self.shape_in} vs {self.shape_out}")

    @property
    def event_ndims_in(self):  # type: ignore[override]
        return len(self.shape_in)

    @property
    def event_ndims_out(self):  # type: ignore[override]
        return len(self.shape_out)

    def forward_event_shape(self, shape):
        shape = tuple(shape)
        if shape[len(shape) - len(self.shape_in):] != self.shape_in:
            raise ValueError(f"event shape {shape} does not end in {self.shape_in}")
        return shape[: len(shape) - len(self.shape_in)] + self.shape_out

    def inverse_event_shape(self, shape):
        shape = tuple(shape)
        return shape[: len(shape) - len(self.shape_out)] + self.shape_in

    def _move(self, x, frm, to):
        batch = tuple(x.shape[: x.ndim - len(frm)])
        return x.reshape(batch + to), x.new_zeros(batch)

    def forward_and_log_det(self, x):
        return self._move(x, self.shape_in, self.shape_out)

    def inverse_and_log_det(self, y):
        return self._move(y, self.shape_out, self.shape_in)

    def _self_inverse(self):
        return Reshape(self.shape_out, self.shape_in)


@bijector_dataclass
class Permute(Bijector):
    """y = x[..., perm] along the event axis, log|J| = 0 (reference
    permute.jl)."""

    perm: tuple

    event_ndims_in = 1
    event_ndims_out = 1

    def __post_init__(self):
        perm = tuple(int(p) for p in self.perm)
        if sorted(perm) != list(range(len(perm))):
            raise ValueError(f"not a permutation: {perm}")
        object.__setattr__(self, "perm", perm)

    # the reference's other constructor forms (permute.jl:84-153)

    @classmethod
    def from_matrix(cls, A) -> "Permute":
        """From a 0/1 permutation matrix: y = A @ x. A signed orthogonal
        matrix is refused."""
        A = np.asarray(A)
        n = A.shape[0]
        if (A.shape != (n, n) or not np.all((A == 0) | (A == 1))
                or not np.array_equal(A @ A.T, np.eye(n))):
            raise ValueError("not a permutation matrix")
        # y[i] = x[j] where A[i, j] == 1
        return cls(tuple(int(np.argmax(A[i])) for i in range(n)))

    @classmethod
    def from_pairs(cls, n: int, mapping) -> "Permute":
        """From src -> dst pairs, other indices fixed: `from_pairs(2, {0: 1,
        1: 0})` (the reference's `Permute(2, 1 => 2, 2 => 1)`,
        permute.jl:102-123, 0-based)."""
        mapping = dict(mapping)
        srcs, dsts = list(mapping.keys()), list(mapping.values())
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or set(srcs) != set(dsts):
            raise ValueError(f"non-bijective index mapping: {mapping}")
        perm = list(range(n))
        for s, t in mapping.items():  # y[dst] = x[src]
            perm[int(t)] = int(s)
        return cls(tuple(perm))

    @classmethod
    def from_destinations(cls, dests) -> "Permute":
        """From a destinations vector, y[dests[i]] = x[i] (the reference's
        `Permute(indices)` scatter convention, permute.jl:90-100)."""
        dests = [int(d) for d in dests]
        if sorted(dests) != list(range(len(dests))):
            raise ValueError(f"not a permutation: {dests}")
        perm = [0] * len(dests)
        for src, dst in enumerate(dests):
            perm[dst] = src
        return cls(tuple(perm))

    @classmethod
    def from_vector_pairs(cls, n: int, *pairs) -> "Permute":
        """From (srcs, dsts) vector pairs, other indices fixed (the
        reference's `Permute(n, [1, 2] => [2, 1], ...)`,
        permute.jl:125-153, 0-based)."""
        mapping = {}
        for srcs, dsts in pairs:
            if len(srcs) != len(dsts):
                raise ValueError(f"{srcs} => {dsts} is not bijective")
            for s, t in zip(srcs, dsts):
                if int(s) in mapping:
                    raise ValueError(f"source {s} used more than once")
                mapping[int(s)] = int(t)
        return cls.from_pairs(n, mapping)

    @property
    def _inv_perm(self):
        return tuple(int(i) for i in np.argsort(np.asarray(self.perm)))

    @staticmethod
    def _gather(x, perm):
        return x[..., torch.as_tensor(perm, device=x.device)]

    def forward_and_log_det(self, x):
        return self.forward(x), x.new_zeros(x.shape[:-1])

    def inverse_and_log_det(self, y):
        return self.inverse(y), y.new_zeros(y.shape[:-1])

    def forward(self, x):
        return self._gather(x, self.perm)

    def inverse(self, y):
        return self._gather(y, self._inv_perm)

    def _self_inverse(self):
        return Permute(self._inv_perm)
