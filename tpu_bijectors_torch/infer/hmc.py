"""HMC building blocks, PyTorch counterpart of `tpu_bijectors/infer/hmc.py`
(diagonal metric): the divergence threshold, the per-transition
diagnostics, the inverse-mass product, the momentum draw and the tree
counter's bit trick. The NUTS tree itself is in hmc_batched.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_ENERGY_DELTA = 1000.0  # divergence threshold (Stan's default)


class NutsInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean Metropolis accept stat over the trajectory
    diverging: torch.Tensor
    n_steps: torch.Tensor  # number of leapfrog steps taken
    energy: torch.Tensor
    tree_depth: torch.Tensor


def _trailing_zeros(n: int) -> int:
    """Trailing zero bits of the host int n > 0 (the tree counter is a
    host int in the port)."""
    return (n & -n).bit_length() - 1


def apply_inv_mass(inv_mass, p):
    """M^{-1} p for a diagonal metric. `inv_mass` broadcasts against p:
    (dim,) against batch-major rows (chains, dim), (dim, 1) against the
    columns of the transposed (dim, chains) state or a (S, dim, chains)
    stack. The dense (dim, dim) metric is not ported (init_sampler
    refuses it)."""
    return p * inv_mass


def sample_momentum(generator, q, inv_mass):
    """p ~ N(0, M), M = diag(1 / inv_mass), the shape of q, drawn from
    `generator` (on q's device); `inv_mass` broadcasts as in
    `apply_inv_mass`."""
    z = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
    return z / torch.sqrt(inv_mass)
