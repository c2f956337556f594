"""Simulation-based calibration (Talts, Betancourt, Simpson, Vehtari &
Gelman 2018), PyTorch counterpart of `tpu_bijectors/infer/sbc.py`: the
end-to-end correctness check of a sampler and model pair.

Each simulation draws theta0 from the prior, data y ~ p(y | theta0),
samples p(theta | y) and records the rank of theta0 among the posterior
draws; with a sampler that targets the posterior, every rank is uniform
on {0, ..., L}. The rank statistics are the linked (unconstrained)
coordinates the samplers produce.

All simulations run as one batched sampler: the simulations are the
chains, each chain's likelihood on its own dataset (the leading axis of
the simulated data). `simulate(generator, x)` takes the whole batch of
prior draws and returns the batch of datasets: the contract of
predictive.py (a `torch.Generator` has no per-draw split for a vmap to
run over).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dists.base import first_param
from ..vectorize.core import unconstrain


class SBCResult(NamedTuple):
    ranks: torch.Tensor  # (n_sims, dim) integer ranks in {0, ..., n_draws}
    n_draws: int  # L: posterior draws a simulation after thinning
    theta0: object  # the prior draws (constrained, leading (n_sims,) axes)


def sbc_ranks(
    prior,
    simulate,
    loglik,
    generator,
    n_sims: int = 64,
    n_warmup: int = 300,
    n_samples: int = 512,
    thin: int = 4,
    kernel: str = "nuts_batched",
    **kernel_kwargs,
) -> SBCResult:
    """The whole SBC study as one batched sampler run (`sample_with_kernel`
    with `kernel`, any batch-major kernel name or 'chees').

    prior: a distribution `unconstrain` supports, on the device the study
    runs on. simulate: callable(generator, x) -> the datasets of the batch
    of draws x. loglik: callable(data, x) -> the scalar log-likelihood of
    one simulation (vmapped over the simulations). thin: every thin-th
    draw enters the rank (near-independent draws; Talts et al. section
    5.1). The chains start at the true draws, points typical of their
    posteriors, so short warmups adapt cleanly."""
    from .sampler import sample_with_kernel

    p = first_param(prior)
    u = unconstrain(prior, device=p.device if p is not None else None)
    theta0 = prior.sample(generator, (n_sims,))
    v0, _ = u.to_linked_vec(theta0)
    data = simulate(generator, theta0)

    def batched_logp(v):
        if v.ndim == 1:
            raise ValueError("sbc log-density is batch-only")
        x, lp = u.from_linked_vec_with_logpdf(v)
        return lp + torch.func.vmap(loglik)(data, x)

    batched_logp.batch_capable = True
    samples, _, _ = sample_with_kernel(batched_logp, generator, v0, n_warmup=n_warmup,
                                       n_samples=n_samples, kernel=kernel, **kernel_kwargs)
    kept = samples[::thin]  # (L, n_sims, dim)
    ranks = torch.sum(kept < v0[None], dim=0)
    return SBCResult(ranks, kept.shape[0], theta0)


def sbc_uniformity(ranks, n_draws: int, n_bins: int | None = None):
    """Chi-square uniformity p-value of each coordinate's ranks.

    ranks: (n_sims, dim) in {0 .. n_draws}. The expected count of a bin is
    exact for any (n_draws + 1, n_bins) pair (the bins need not divide the
    rank range; Talts et al. recommend n_sims / n_bins >= ~5). Returns
    (dim,) float64 p-values: a calibrated sampler gives p ~ U(0, 1), a
    biased or over/under-dispersed posterior drives p to 0."""
    ranks = torch.as_tensor(ranks)
    n_sims = ranks.shape[0]
    if n_bins is None:
        n_bins = max(2, min(20, n_sims // 8))
    f64 = dict(dtype=torch.float64, device=ranks.device)
    edges = torch.linspace(0.0, n_draws + 1.0, n_bins + 1, **f64)

    def bin_of(r):
        b = torch.searchsorted(edges, r.to(torch.float64) + 0.5, right=True) - 1
        return torch.clamp(b, 0, n_bins - 1)

    one_hot = torch.nn.functional.one_hot(bin_of(ranks), n_bins)  # (n_sims, dim, n_bins)
    counts = one_hot.sum(dim=0).to(torch.float64)  # (dim, n_bins)
    # exact null: rank uniform on {0 .. n_draws}, so bin b expects its
    # share of the integer rank values
    vals = torch.bincount(bin_of(torch.arange(n_draws + 1, device=ranks.device)),
                          minlength=n_bins).to(torch.float64)
    expected = n_sims * vals / (n_draws + 1.0)
    stat = torch.sum((counts - expected) ** 2 / expected, dim=1)
    dof = torch.full_like(stat, (n_bins - 1) / 2.0)
    return torch.special.gammaincc(dof, stat / 2.0)  # the chi-square survival function
