"""Marginal-likelihood estimation, PyTorch counterpart of
`tpu_bijectors/infer/evidence.py`: importance sampling from a fitted
proposal, and bridge sampling (Meng & Wong 1996) between posterior draws
and the proposal.

The proposal is any object with `.sample(generator, n)` and a normalised
`.logdensity(v)`: a `LaplaceApprox` (`map_laplace`'s output is the
standard choice) or an ADVI Gaussian. Every density call is one batched
call (`as_batched`) over all n draws, so the link kernels run at large B.
The bridge's fixed point runs `n_iters` iterations in log space
(logaddexp / logsumexp: no overflow for peaked posteriors), a host loop of
tensor operations with no read.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .loo import fit_gpd
from .model import as_batched


class ISResult(NamedTuple):
    log_evidence: torch.Tensor
    ess: torch.Tensor  # importance-weight effective sample size
    pareto_k: torch.Tensor  # GPD tail shape of the weights (> 0.7 = unreliable)


class BridgeResult(NamedTuple):
    log_evidence: torch.Tensor  # final log Z estimate
    trace: torch.Tensor  # (n_iters,) per-iteration log r (convergence check)
    rel_mc_error: torch.Tensor  # rough relative MC error of exp-scale Z


def _log_ratio(blogp, proposal, v):
    """log p~(v) - log g(v) (n,), non-finite values as -inf."""
    lw = blogp(v).detach() - proposal.logdensity(v)
    return torch.where(torch.isfinite(lw), lw, torch.full_like(lw, -math.inf))


def _is_from_draws(blogp, proposal, draws) -> ISResult:
    """The importance-sampling estimate on the proposal's draws (n, dim)."""
    n = draws.shape[0]
    logw = _log_ratio(blogp, proposal, draws)
    lse = torch.logsumexp(logw, dim=0)
    log_z = lse - math.log(float(n))
    ess = torch.exp(2.0 * lse - torch.logsumexp(2.0 * logw, dim=0))
    # the GPD fit to the top ~20% of the weights, as psis_loo does it:
    # exclusive cutoff, exceedances stabilised by the tail's max
    m_tail = int(min(0.2 * n, 3.0 * (n**0.5)))
    if m_tail < 5:
        raise ValueError(f"too few draws ({n}) for the Pareto-k tail fit")
    srt = torch.sort(logw).values
    cutoff, tail = srt[-m_tail - 1], srt[-m_tail:]
    mx = tail[-1]
    k_fit, _ = fit_gpd(torch.exp(tail - mx) - torch.exp(cutoff - mx))
    # a degenerate tail (all weights equal to float precision) starves the
    # grid; that regime is light-tailed by definition
    k = torch.where(mx - cutoff > 1e-8, k_fit, torch.full_like(k_fit, -0.5))
    return ISResult(log_z, ess, k)


def importance_sampling_evidence(logdensity_fn, proposal, generator, n: int = 4096) -> ISResult:
    """log Z ~ lse_i(log p~(v_i) - log g(v_i)) - log n, v_i ~ g, from
    `generator`: cheaper than bridge sampling (no posterior draws), but
    only trustworthy where g covers the posterior: check `ess` and
    `pareto_k` (Yao et al. 2018: k > 0.7 means effectively infinite
    variance). One batched density call."""
    return _is_from_draws(as_batched(logdensity_fn), proposal, proposal.sample(generator, n))


def _bridge_from_draws(blogp, posterior_draws, proposal, prop, n_iters: int) -> BridgeResult:
    """The bridge fixed point given posterior draws (N1, dim) and the
    proposal's draws (N2, dim)."""
    n1, n2 = posterior_draws.shape[0], prop.shape[0]
    l1 = _log_ratio(blogp, proposal, posterior_draws)
    l2 = _log_ratio(blogp, proposal, prop)
    ls1, ls2 = math.log(n1 / (n1 + n2)), math.log(n2 / (n1 + n2))
    log_n1, log_n2 = math.log(n1), math.log(n2)
    # start at the (cheap, biased-low) reciprocal-importance estimate
    log_r = torch.logsumexp(l2, dim=0) - log_n2
    trace = []
    for _ in range(n_iters):
        a = torch.logaddexp(ls1 + l2, ls2 + log_r)
        b = torch.logaddexp(ls1 + l1, ls2 + log_r)
        log_r = (torch.logsumexp(l2 - a, dim=0) - log_n2) - (torch.logsumexp(-b, dim=0) - log_n1)
        trace.append(log_r)
    # a rough relative error (Fruhwirth-Schnatter): the variances of the
    # two bridge-weight populations, a sanity flag rather than an interval
    a = torch.logaddexp(ls1 + l2, ls2 + log_r)
    b = torch.logaddexp(ls1 + l1, ls2 + log_r)
    f2 = torch.exp(l2 - a - (torch.logsumexp(l2 - a, dim=0) - log_n2))
    f1 = torch.exp(log_r - b - (torch.logsumexp(log_r - b, dim=0) - log_n1))
    rel = torch.sqrt(torch.var(f2, unbiased=False) / n2 + torch.var(f1, unbiased=False) / n1)
    trace = torch.stack(trace) if trace else l1.new_empty((0,))
    return BridgeResult(log_r, trace, rel)


def bridge_sampling_evidence(logdensity_fn, posterior_draws, proposal, generator,
                             n_proposal: int | None = None, n_iters: int = 64) -> BridgeResult:
    """Bridge-sampling log Z from posterior_draws (N1, dim) in linked space
    (Model.sample with constrained=False flattened over chains, SMC
    particles) and n_proposal (default N1) draws of `proposal` from
    `generator`. The optimal-bridge iteration in log space (Meng & Wong
    eq. 4.4):

        log r <- [lse_j(l2_j - A_j) - log N2] - [lse_i(-B_i) - log N1]
        A = logaddexp(log s1 + l2, log s2 + log r)
        B = logaddexp(log s1 + l1, log s2 + log r)

    with l = log p~ - log g at the posterior (l1) and proposal (l2) draws,
    s1 = N1 / (N1 + N2), s2 = N2 / (N1 + N2); `n_iters` iterations (a
    contraction; 64 is far past convergence, see `trace`)."""
    n2 = n_proposal or posterior_draws.shape[0]
    return _bridge_from_draws(as_batched(logdensity_fn), posterior_draws, proposal,
                              proposal.sample(generator, n2), n_iters)
