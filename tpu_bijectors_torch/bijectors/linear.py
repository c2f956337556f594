"""General and triangular linear maps, PyTorch counterparts of
`tpu_bijectors/bijectors/linear.py` (the reference's matrix-`a` Scale,
src/bijectors/scale.jl:13-36: y = A x, log|J| = logabsdet(A), inverse by
a solve). On `torch.linalg` on either device, as the JAX package computes
them in jnp; the card's float32 products run at full precision where
TF32 is off, torch's default for matmuls.
"""

from __future__ import annotations

import torch

from .base import Bijector, bijector_dataclass


def _matvec(A, x):
    return torch.einsum("ij,...j->...i", A, x)


def _columns(solve, y):
    """solve(Y) on the (d, N) matrix of y's N vectors: one factorisation
    for the whole batch."""
    d = y.shape[-1]
    return solve(y.reshape(-1, d).T).T.reshape(y.shape)


@bijector_dataclass
class LinearMap(Bijector):
    """y = A x for an invertible (d, d) A; log|J| = log|det A|."""

    A: object

    event_ndims_in = 1
    event_ndims_out = 1

    def _logdet(self, x):
        return torch.linalg.slogdet(self.A)[1].expand(x.shape[:-1])

    def forward_and_log_det(self, x):
        return self.forward(x), self._logdet(x)

    def forward(self, x):
        return _matvec(self.A, x)

    def inverse_and_log_det(self, y):
        return self.inverse(y), -self._logdet(y)

    def inverse(self, y):
        return _columns(lambda Y: torch.linalg.solve(self.A, Y), y)


@bijector_dataclass
class TriangularLinearMap(Bijector):
    """y = T x with T triangular (its other triangle ignored): a
    triangular solve, the log-det from the diagonal."""

    T: object
    lower: bool = True

    event_ndims_in = 1
    event_ndims_out = 1

    def _t(self):
        return torch.tril(self.T) if self.lower else torch.triu(self.T)

    def _logdet(self, x):
        return torch.sum(torch.log(torch.abs(torch.diagonal(self.T)))).expand(x.shape[:-1])

    def forward_and_log_det(self, x):
        return self.forward(x), self._logdet(x)

    def forward(self, x):
        return _matvec(self._t(), x)

    def inverse_and_log_det(self, y):
        T = self._t()
        x = _columns(lambda Y: torch.linalg.solve_triangular(T, Y, upper=not self.lower), y)
        return x, -self._logdet(y)
