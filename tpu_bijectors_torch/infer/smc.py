"""Tempered Sequential Monte Carlo with systematic resampling, PyTorch
counterpart of `tpu_bijectors/infer/smc.py`.

Particles are the batch axis: the densities, the weights and the mutation
run on the whole block, batch-major (N, dim) or transposed (dim, N), where
a `Model.batched_logdensity_t_fn` prior runs the whole-model kernels (the
value kernel, and its vector-Jacobian kernel in the HMC mutation's
backward). Resampling is a prefix sum and one `searchsorted`.

Algorithm: adaptive-temperature SMC from the prior to the posterior. At
each stage the next inverse temperature beta is the largest one whose
incremental weights keep the effective sample size at `target_ess` (30
bisection steps on the device), the particles are resampled
systematically, then mutated by a few random-walk Metropolis or HMC steps
at that temperature. The JAX package's `while_loop` over stages is a host
loop here: its condition reads beta once a stage
(`hmc_batched.SYNCS['stage']`). In the transposed layout the resampling
gather `P[:, idx]` copies the (dim, N) block.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .hmc_batched import SYNCS, _batched_logp_and_grad, hmc_kernel_batched
from .model import as_batched


def _systematic_resample(log_weights, u0):
    """Parent indices (N,) of systematic resampling given its uniform u0.
    side='right': the first index whose cumulative weight exceeds the
    point, so u0 = 0 does not resurrect a zero-weight prefix particle; the
    float cumulative sum may end below 1, so the index is clamped to
    N - 1."""
    n = log_weights.shape[0]
    w = torch.softmax(log_weights, dim=0)
    cum = torch.cumsum(w, dim=0)
    pts = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    idx = torch.searchsorted(cum, pts, right=True)
    return torch.clamp(idx, 0, n - 1)


def systematic_resample(generator, log_weights):
    """Systematic resampling: parent indices (N,), one uniform from
    `generator`."""
    u0 = torch.rand((), generator=generator, dtype=log_weights.dtype,
                    device=log_weights.device)
    return _systematic_resample(log_weights, u0)


def ess(log_weights):
    lw = log_weights - torch.logsumexp(log_weights, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * lw, dim=0))


class SMCState(NamedTuple):
    generator: torch.Generator
    particles: torch.Tensor  # (N, dim), or (dim, N) in transposed mode
    log_prior: torch.Tensor
    log_lik: torch.Tensor
    beta: torch.Tensor
    log_evidence: torch.Tensor
    stage: int


class SMCResult(NamedTuple):
    particles: torch.Tensor
    log_evidence: torch.Tensor
    n_stages: int
    final_beta: torch.Tensor


def _find_next_beta(log_lik, beta, target_ess_frac: float, n_bisect: int = 30):
    """The largest beta' in (beta, 1] whose incremental weights keep
    ESS >= target_ess_frac * N, by bisection on the device."""
    target = target_ess_frac * log_lik.shape[0]

    def ess_at(b):
        return ess((b - beta) * log_lik)

    one = torch.ones_like(beta)
    full = ess_at(one)
    lo, hi = beta, one
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    nb = torch.where(full >= target, one, lo)
    # strict progress: where no beta' reaches the target (most particles
    # at log_lik = -inf), lo stays at beta, the incremental weights would be
    # 0 * (-inf) = NaN and the stages would stall. A minimal step instead
    # (one stage of low ESS is for resampling to handle); near 1 the clamp
    # lands on 1 and ends the run.
    return torch.clamp_max(torch.maximum(nb, beta + 1e-6), 1.0)


def run_smc(
    log_prior_fn,
    log_lik_fn,
    generator,
    particles0,
    n_mutations: int = 5,
    target_ess: float = 0.5,
    max_stages: int = 50,
    rw_scale: float = 0.3,
    mutation: str = "rwm",
    hmc_eps: float = 0.2,
    hmc_leapfrog: int = 8,
    transposed: bool = False,
) -> SMCResult:
    """Tempered SMC from `log_prior_fn` to `log_prior_fn + log_lik_fn` on
    flat unconstrained vectors. particles0: (N, dim) draws from the prior,
    or with transposed=True (dim, N), the layout of the whole-model kernels
    (pass Model.batched_logdensity_t_fn-style callables). Both densities
    are evaluated on the whole block: per-sample callables are lifted by
    `as_batched`; transposed mode requires batch-capable ones (a (dim,)
    per-sample density has no meaning there). Every draw comes from
    `generator` (on the particles' device)."""
    if transposed:
        dim, n = particles0.shape
    else:
        n, dim = particles0.shape
    dtype, dev = particles0.dtype, particles0.device
    if transposed and not (
        getattr(log_prior_fn, "batch_capable", False)
        and getattr(log_lik_fn, "batch_capable", False)
    ):
        raise ValueError(
            "transposed=True requires batch-capable log densities mapping "
            "(dim, N) -> (N,) (e.g. Model.batched_logdensity_t_fn)"
        )
    blp, bll = as_batched(log_prior_fn), as_batched(log_lik_fn)

    def bexp(m):
        return m[None, :] if transposed else m[:, None]

    def gather(P, idx):
        return P[:, idx] if transposed else P[idx]

    def btempered(beta):
        def f(v):
            return blp(v) + beta * bll(v)

        return f

    def mutate_rwm(particles, beta):
        f = btempered(beta)
        with torch.no_grad():
            lp = f(particles)
            for _ in range(n_mutations):
                prop = particles + rw_scale * torch.randn(
                    particles.shape, generator=generator, dtype=dtype, device=dev
                )
                lp_prop = f(prop)
                u = torch.rand(n, generator=generator, dtype=dtype, device=dev)
                accept = torch.log(u) < lp_prop - lp
                particles = torch.where(bexp(accept), prop, particles)
                lp = torch.where(accept, lp_prop, lp)
        return particles

    def mutate_hmc(particles, beta):
        f = btempered(beta)
        kern = hmc_kernel_batched(f, n_leapfrog=hmc_leapfrog, transposed=transposed)
        lp, grad = _batched_logp_and_grad(f)(particles)
        inv_mass = torch.ones(dim, dtype=dtype, device=dev)
        eps = torch.tensor(hmc_eps, dtype=dtype, device=dev)
        q = particles
        for _ in range(n_mutations):
            q, lp, grad, _ = kern(generator, q, lp, grad, eps, inv_mass)
        return q

    mutate = mutate_hmc if mutation == "hmc" else mutate_rwm

    def stage(state: SMCState) -> SMCState:
        new_beta = _find_next_beta(state.log_lik, state.beta, target_ess)
        inc = (new_beta - state.beta) * state.log_lik
        log_ev = state.log_evidence + (torch.logsumexp(inc, dim=0) - math.log(float(n)))
        idx = systematic_resample(generator, inc)
        particles = mutate(gather(state.particles, idx), new_beta)
        with torch.no_grad():
            lp, ll = blp(particles), bll(particles)
        return SMCState(generator, particles, lp, ll, new_beta, log_ev, state.stage + 1)

    with torch.no_grad():
        lp0, ll0 = blp(particles0), bll(particles0)
    zero = torch.zeros((), dtype=dtype, device=dev)
    state = SMCState(generator, particles0, lp0, ll0, zero, zero, 0)
    while state.stage < max_stages:
        SYNCS["stage"] += 1
        if not bool(state.beta < 1.0):
            break
        state = stage(state)
    return SMCResult(state.particles, state.log_evidence, state.stage, state.beta)
