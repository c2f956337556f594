"""HMC building blocks, PyTorch counterpart of `tpu_bijectors/infer/hmc.py`:
the divergence threshold, the integrator state and its leapfrog step, the
kinetic energy, the inverse-mass product and the momentum draw of a
diagonal (dim,) or dense (dim, dim) metric, the per-transition diagnostics
and the tree counter's bit trick.

There is one NUTS tree and one fixed-trajectory transition, both in
hmc_batched.py: the single-chain `nuts_kernel` and `hmc_kernel` here are
their C = 1 cases, as in the JAX package.

A dense metric's products stay at float32's full precision on the card:
the port leaves TF32 off (`torch.backends.cuda.matmul.allow_tf32` False,
`torch.get_float32_matmul_precision()` 'highest'), since its rounding
breaks the leapfrog's reversibility (the JAX package asks for
`Precision.HIGHEST` for the same reason).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_ENERGY_DELTA = 1000.0  # divergence threshold (Stan's default)


class IntegratorState(NamedTuple):
    q: torch.Tensor  # position
    p: torch.Tensor  # momentum
    logp: torch.Tensor  # target log-density at q
    grad: torch.Tensor  # d logp / d q


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


def _is_dense(inv_mass, p) -> bool:
    """A dense metric is a square (dim, dim) matrix over the last axis of p;
    anything else is a diagonal that broadcasts against p."""
    return inv_mass.ndim == 2 and inv_mass.shape[0] == inv_mass.shape[1] == p.shape[-1]


def apply_inv_mass(inv_mass, p):
    """M^{-1} p on the rows of p (leading batch axes allowed) for a dense
    symmetric (dim, dim) metric, or for a diagonal that broadcasts against
    p: (dim,) against rows, (dim, 1) against the columns of the transposed
    (dim, chains) state or a (S, dim, chains) stack."""
    if _is_dense(inv_mass, p):
        return torch.matmul(p, inv_mass)
    return p * inv_mass


def momentum_from_z(z, inv_mass):
    """The momentum p ~ N(0, M), M = inv(inv_mass), from a standard normal
    z of the state's shape, on the rows of z; `inv_mass` as in
    `apply_inv_mass`. Dense: inv_mass = L L' and p = L^{-T} z, whose
    covariance is (L L')^{-1} = M."""
    if not _is_dense(inv_mass, z):
        return z / torch.sqrt(inv_mass)
    L = torch.linalg.cholesky(inv_mass.to(z.dtype))
    rows = z.reshape(-1, z.shape[-1])
    return torch.linalg.solve_triangular(L.T, rows.T, upper=True).T.reshape(z.shape)


def sample_momentum(generator, q, inv_mass):
    """p ~ N(0, M) of the shape of q, drawn from `generator` (on q's
    device); `inv_mass` as in `apply_inv_mass`."""
    z = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
    return momentum_from_z(z, inv_mass)


def leapfrog(logp_and_grad, state: IntegratorState, eps, inv_mass) -> IntegratorState:
    q, p, _, grad = state
    p_half = p + 0.5 * eps * grad
    q_new = q + eps * apply_inv_mass(inv_mass, p_half)
    logp_new, grad_new = logp_and_grad(q_new)
    p_new = p_half + 0.5 * eps * grad_new
    return IntegratorState(q_new, p_new, logp_new, grad_new)


def kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * apply_inv_mass(inv_mass, p), dim=-1)


def _single_chain(batched_kernel):
    """The (generator, q (dim,), logp (), grad (dim,), eps, inv_mass)
    kernel of one chain: the batched kernel on a block of one."""

    def kernel(generator, q, logp, grad, eps, inv_mass):
        q1, logp1, grad1, info = batched_kernel(
            generator, q[None, :], logp[None], grad[None, :], eps, inv_mass
        )
        return q1[0], logp1[0], grad1[0], NutsInfo(*(a[0] for a in info))

    return kernel


def nuts_kernel(logdensity_fn, max_depth: int = 10):
    """A NUTS transition of one chain on a per-example density (dim,) -> ():
    (generator, q, logp, grad, eps, inv_mass) -> (q', logp', grad',
    NutsInfo). The C = 1 case of hmc_batched.nuts_kernel_batched on the
    density lifted by model.as_batched."""
    from .hmc_batched import nuts_kernel_batched
    from .model import as_batched

    return _single_chain(nuts_kernel_batched(as_batched(logdensity_fn), max_depth=max_depth))


def hmc_kernel(logdensity_fn, n_leapfrog: int = 32, jitter: float = 0.2):
    """Fixed-trajectory HMC of one chain with step-size jitter (uniform in
    [1 - jitter, 1 + jitter]): the C = 1 case of
    hmc_batched.hmc_kernel_batched on the lifted density."""
    from .hmc_batched import hmc_kernel_batched
    from .model import as_batched

    return _single_chain(
        hmc_kernel_batched(as_batched(logdensity_fn), n_leapfrog=n_leapfrog, jitter=jitter)
    )
