"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move),
PyTorch counterpart of `tpu_bijectors/infer/ensemble.py`: the
gradient-free complement to the HMC family, for targets whose density is
non-differentiable, flat in places or supplied from outside. Affine
invariance makes it indifferent to linear correlation and scale; `a` is
its one setting.

The ensemble is two half-ensembles moved in turn (emcee's red-black
scheme): every walker of a half moves at once against a partner drawn
from the other, frozen half, which keeps detailed balance and makes a
sweep two density calls on (N/2, dim) blocks (`as_batched`, so a batched
density such as `Model.batched_logdensity_fn` runs its kernels on the
block). The JAX package's `lax.scan` is a host loop; a sweep reads
nothing back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .model import as_batched


class EnsembleResult(NamedTuple):
    samples: torch.Tensor  # (n_kept, n_walkers, dim)
    logp: torch.Tensor  # (n_kept, n_walkers)
    accept_rate: torch.Tensor  # scalar mean acceptance


def run_ensemble(
    logdensity_fn,
    generator,
    q0,
    n_warmup: int = 500,
    n_samples: int = 1000,
    a: float = 2.0,
    thin: int = 1,
) -> EnsembleResult:
    """q0: (n_walkers, dim); use at least 2 * dim walkers (the ensemble
    spans the space; fewer degenerate), an even number of them. Every draw
    comes from `generator` (on q0's device)."""
    blogp = as_batched(logdensity_fn)
    n_walkers, dim = q0.shape
    if n_walkers % 2:
        raise ValueError("n_walkers must be even (half-ensemble scheme)")
    if n_walkers < 4:
        raise ValueError("need at least 4 walkers")
    half = n_walkers // 2
    dtype, dev = q0.dtype, q0.device
    sqrt_a = math.sqrt(a)

    def logp(v):
        lp = blogp(v)
        return torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))

    def rand(shape):
        return torch.rand(shape, generator=generator, dtype=dtype, device=dev)

    def half_move(active, frozen, lp_active):
        """Stretch every active walker against a random frozen partner:
        y = x_j + z (x_i - x_j), z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] (drawn as
        (u (sqrt(a) - 1/sqrt(a)) + 1/sqrt(a))^2), accepted with
        z^(d-1) pi(y) / pi(x)."""
        j = torch.randint(0, half, (half,), generator=generator, device=dev)
        partner = frozen[j]
        z = (rand(half) * (sqrt_a - 1.0 / sqrt_a) + 1.0 / sqrt_a) ** 2
        y = partner + z[:, None] * (active - partner)
        lp_y = logp(y)
        log_r = (dim - 1) * torch.log(z) + lp_y - lp_active
        acc = torch.log(rand(half)) < log_r
        return torch.where(acc[:, None], y, active), torch.where(acc, lp_y, lp_active), acc

    def sweep(q, lp):
        q_a, lp_a, acc_a = half_move(q[:half], q[half:], lp[:half])
        q_b, lp_b, acc_b = half_move(q[half:], q_a, lp[half:])
        acc = torch.mean(torch.cat([acc_a, acc_b]).to(dtype))
        return torch.cat([q_a, q_b]), torch.cat([lp_a, lp_b]), acc

    with torch.no_grad():
        q, lp = q0, logp(q0)
        for _ in range(n_warmup):
            q, lp, _ = sweep(q, lp)
        qs, lps, accs = [], [], []
        for _ in range(n_samples):
            q, lp, acc = sweep(q, lp)
            qs.append(q)
            lps.append(lp)
            accs.append(acc)
    step = max(thin, 1)
    return EnsembleResult(torch.stack(qs)[::step], torch.stack(lps)[::step],
                          torch.mean(torch.stack(accs)))
