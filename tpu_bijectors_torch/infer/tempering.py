"""Parallel tempering (replica exchange) with batched HMC moves, PyTorch
counterpart of `tpu_bijectors/infer/tempering.py`.

A ladder of K tempered targets

    pi_k(v) ∝ prior(v) * lik(v)^beta_k,      0 = beta_0 < ... < beta_{K-1} = 1

runs side by side, and adjacent temperatures exchange states, so the cold
chain's modes mix through the hot end. The interface is `run_smc`'s: a
log prior and a log likelihood on flat unconstrained vectors (`Model`'s
batched densities for a constrained model), each lifted to whole blocks
by `as_batched`.

- The whole (K temperatures x N chains) lattice moves as one block of
  (K*N, dim) leapfrogs: each density and its vector-Jacobian product runs
  once a leapfrog on the whole lattice, the likelihood's cotangent the
  per-rung beta column.
- Swaps are the deterministic even-odd (non-reversible) scheme of Syed et
  al. 2021: pair (k, k+1) is tried on the sweeps of its parity, one
  gather and `where` a sweep.
- Step sizes and diagonal masses adapt per temperature in warmup (dual
  averaging and Welford on (K,) and (K, dim) tensors).
- The thermodynamic-integration evidence log Z = int_0^1 E_beta[log lik]
  dbeta is the trapezoid over the ladder.

The JAX package's `lax.scan` over sweeps is a host loop here. The run
reads nothing back to the host and copies nothing to the card: the
accept, swap and adaptation steps are `torch.where`s on the device, and
the run adds nothing to `hmc_batched.SYNCS` (chip_smoke.py counts the
card's synchronizations during a run).

With a `group` (`shard.chain_parallel_pt`: the JAX package's `axis_name`),
each rank runs its block of chain columns of the lattice: the per-rung
acceptance, the swap rates, the Welford statistics and the
thermodynamic-integration means are means over every rank's chains (one
`all_reduce` each), so every rank adapts the same ladder; the swaps stay
within a chain column and cross no rank.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .adapt import (
    StepSizeAdaptState,
    pmean,
    WelfordState,
    stepsize_update,
    welford_update_batch,
    welford_variance,
)
from .hmc_batched import _batched_logp_and_grad
from .model import as_batched


class PTResult(NamedTuple):
    samples: torch.Tensor  # (n_kept, n_chains, dim) cold-chain (beta = 1) draws
    swap_accept: torch.Tensor  # (K-1,) per-attempt swap acceptance of each adjacent pair
    accept: torch.Tensor  # (K,) mean HMC acceptance per temperature
    log_evidence: torch.Tensor  # thermodynamic-integration estimate of log Z
    betas: torch.Tensor  # (K,) the ladder
    eps: torch.Tensor  # (K,) adapted step sizes


def default_ladder(n_temps: int, power: float = 3.0, dtype=torch.float64, device="cpu"):
    """beta_k = (k / (K-1))^power: dense near beta = 1, where the tempered
    targets change fastest; beta_0 = 0 samples the prior exactly. One rung
    is plain HMC on the posterior (beta = 1)."""
    if n_temps == 1:
        return torch.ones(1, dtype=dtype, device=device)
    k = torch.arange(n_temps, dtype=dtype, device=device)
    return (k / (n_temps - 1)) ** power


def _blik_term(b, ll):
    """beta * L with beta = 0 giving 0 where L = -inf: the prior rung stays
    finite (0 * -inf would be NaN, freeze that rung and poison the TI
    integrand)."""
    return torch.where(b > 0, b * ll, torch.zeros_like(ll))


def _finite_or_neg_inf(ll):
    return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))


def run_parallel_tempering(
    log_prior_fn,
    log_lik_fn,
    generator,
    q0,
    n_temps: int = 8,
    betas=None,
    n_warmup: int = 300,
    n_samples: int = 500,
    n_leapfrog: int = 16,
    eps0: float = 0.2,
    target_accept: float = 0.7,
    thin: int = 1,
    group=None,
) -> PTResult:
    """q0: (n_chains, dim) starts, the same on every rung. Returns the cold
    chain's draws; `log_evidence` averages E_beta[log lik] over the
    sampling sweeps and integrates the ladder by trapezoid. Every draw
    comes from `generator` (on q0's device). With `group`, q0 is this
    rank's block of chains and the statistics are shared across the
    group's ranks (the module docstring)."""
    bprior, blik = as_batched(log_prior_fn), as_batched(log_lik_fn)
    prior_vg = _batched_logp_and_grad(bprior)
    n_chains, dim = q0.shape
    dtype, dev = q0.dtype, q0.device
    betas = (default_ladder(n_temps, dtype=dtype, device=dev) if betas is None
             else torch.as_tensor(betas, dtype=dtype, device=dev))
    K = betas.shape[0]
    bcol = betas[:, None].expand(K, n_chains).reshape(-1)
    flat_shape = (K * n_chains, dim)

    def pieces(q):
        """Per-replica (log prior, log lik) of the lattice q (K, N, dim)."""
        with torch.no_grad():
            flat = q.reshape(flat_shape)
            lp = bprior(flat).reshape(K, n_chains)
            ll = blik(flat).reshape(K, n_chains)
        return lp, _finite_or_neg_inf(ll)

    def tempered(lp, ll):
        return lp + _blik_term(betas[:, None], ll)

    def lpg(q):
        """Tempered values and gradients of the whole lattice: one value and
        one vector-Jacobian product a density, beta the likelihood's
        cotangent (a per-example vmap would never reach the batched
        kernels)."""
        flat = q.reshape(flat_shape)
        lp, gp = prior_vg(flat)
        with torch.enable_grad():
            v = flat.detach().requires_grad_(True)
            ll = blik(v)
            gl = None
            if ll.requires_grad:  # a likelihood constant in v has no graph
                (gl,) = torch.autograd.grad(ll, v, grad_outputs=bcol.to(ll.dtype),
                                            allow_unused=True)
        gl = torch.zeros_like(flat) if gl is None else gl
        ll = _finite_or_neg_inf(ll.detach())
        vals = (lp + _blik_term(bcol, ll)).reshape(K, n_chains)
        grads = gp + torch.where(bcol[:, None] > 0, gl, torch.zeros_like(gl))
        return vals, grads.reshape(K, n_chains, dim)

    def hmc_update(q, logp, eps, inv_mass):
        """One fixed-trajectory HMC transition of the whole lattice with the
        per-temperature step sizes eps (K,) and diagonal inverse masses
        inv_mass (K, dim). The gradient is taken anew at q: swaps move
        states between rungs, so a carried one would be stale."""
        e = eps[:, None, None]
        im = inv_mass[:, None, :]
        z = torch.randn(q.shape, generator=generator, dtype=dtype, device=dev)
        p = z / torch.sqrt(im)  # p ~ N(0, M), M = diag(1 / inv_mass)

        def kin(p):
            return 0.5 * torch.sum(p * p * im, dim=-1)

        energy0 = -logp + kin(p)
        qq, (_, g) = q, lpg(q)
        lp_new = logp
        for _ in range(n_leapfrog):
            p_half = p + 0.5 * e * g
            qq = qq + e * (p_half * im)
            lp_new, g = lpg(qq)
            p = p_half + 0.5 * e * g
        delta = -lp_new + kin(p) - energy0
        acc_p = torch.clamp_max(torch.exp(torch.clamp_max(-delta, 0.0)), 1.0)
        acc_p = torch.where(torch.isfinite(delta), acc_p, torch.zeros_like(acc_p))
        accept = torch.rand(acc_p.shape, generator=generator, dtype=dtype, device=dev) < acc_p
        return (torch.where(accept[..., None], qq, q), torch.where(accept, lp_new, logp),
                acc_p)

    # the even-odd pairs of each parity: partner rows and the pairs' lower rows
    k_idx = torch.arange(K, device=dev)
    swap_plan = []
    for parity in (0, 1):
        is_lo = (k_idx % 2 == parity) & (k_idx < K - 1)
        partner = torch.where(
            is_lo, k_idx + 1, torch.where((k_idx - 1) % 2 == parity, k_idx - 1, k_idx))
        swap_plan.append((is_lo, partner))

    def swap(q, lp, ll, parity):
        """Adjacent swaps of pairs (k, k+1) with k = parity (mod 2), accepted
        with exp((beta_{k+1} - beta_k)(L_k - L_{k+1})) per chain column."""
        is_lo, partner = swap_plan[parity]
        d_beta = betas[partner] - betas
        log_r = torch.where(is_lo[:, None], d_beta[:, None] * (ll - ll[partner]),
                            torch.full_like(ll, -torch.inf))  # decided at the pair's lower row
        u = torch.rand((K, n_chains), generator=generator, dtype=dtype, device=dev)
        acc_lo = torch.log(u) < log_r
        acc = acc_lo | acc_lo[partner]  # the lower row of an accepted pair, or its upper
        q2 = torch.where(acc[..., None], q[partner], q)
        lp2 = torch.where(acc, lp[partner], lp)
        ll2 = torch.where(acc, ll[partner], ll)
        # each pair is attempted on its parity's sweeps only: the attempt
        # mask gives the per-attempt rate
        pair_acc = cmean(acc_lo.to(dtype))[:-1]
        return q2, lp2, ll2, pair_acc, is_lo[:-1].to(dtype)

    q = q0[None].expand(K, n_chains, dim).clone()
    lp, ll = pieces(q)
    logp = tempered(lp, ll)
    # adapt.stepsize_init's and welford_init's states, one a rung, filled on
    # the device (no copy from the host)
    f = dict(dtype=dtype, device=dev)
    ss = StepSizeAdaptState(
        torch.full((K,), math.log(eps0), **f), torch.full((K,), math.log(eps0), **f),
        torch.zeros(K, **f), torch.full((K,), math.log(10.0 * eps0), **f),
        torch.zeros(K, dtype=torch.int32, device=dev))
    wf = WelfordState(torch.zeros(K, **f), torch.zeros((K, dim), **f), torch.zeros((K, dim), **f))
    inv_mass = torch.ones((K, dim), dtype=dtype, device=dev)
    def cmean(x):
        """The mean over the chain axis (1) of every rank's chains."""
        return pmean(torch.mean(x, dim=1), group)

    # one accumulator a rung: vmapped on one rank; across ranks the update
    # takes the (K, N, dim) lattice whole (an all_reduce does not vmap)
    wf_update = (torch.func.vmap(welford_update_batch) if group is None
                 else lambda s, x: welford_update_batch(s, x, group))

    def sweep(it, q, logp, lp, ll, eps, inv_mass):
        """Sweep `it`: one HMC update and one swap round."""
        q, logp, acc_p = hmc_update(q, logp, eps, inv_mass)
        lp, ll = pieces(q)
        q, lp, ll, pair_acc, attempted = swap(q, lp, ll, it % 2)
        return q, tempered(lp, ll), lp, ll, cmean(acc_p), pair_acc, attempted

    for it in range(n_warmup):
        q, logp, lp, ll, acc_mean, _, _ = sweep(it, q, logp, lp, ll, torch.exp(ss.log_eps),
                                                inv_mass)
        ss = stepsize_update(ss, acc_mean, target=target_accept)
        wf = wf_update(wf, q)

    # freeze: the step sizes at the dual-averaging means, the masses at the
    # Welford variances
    eps = torch.exp(ss.log_eps_bar)
    inv_mass = torch.clamp_min(torch.func.vmap(welford_variance)(wf), 1e-10)
    cold, accs, pair_accs, attempts, mean_lls = [], [], [], [], []
    for it in range(n_warmup, n_warmup + n_samples):
        q, logp, lp, ll, acc_mean, pair_acc, attempted = sweep(it, q, logp, lp, ll, eps,
                                                               inv_mass)
        cold.append(q[-1])
        accs.append(acc_mean)
        pair_accs.append(pair_acc)
        attempts.append(attempted)
        mean_lls.append(cmean(ll))

    log_z = torch.trapezoid(torch.mean(torch.stack(mean_lls), dim=0), betas)
    swap_accept = torch.sum(torch.stack(pair_accs), dim=0) / torch.clamp_min(
        torch.sum(torch.stack(attempts), dim=0), 1.0)
    return PTResult(
        samples=torch.stack(cold)[:: max(thin, 1)],
        swap_accept=swap_accept,
        accept=torch.mean(torch.stack(accs), dim=0),
        log_evidence=log_z,
        betas=betas,
        eps=eps,
    )
