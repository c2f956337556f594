"""NUTS/HMC sampling driver, PyTorch counterpart of
`tpu_bijectors/infer/sampler.py`: windowed-adaptation warmup with a
diagonal or dense metric, then sampling, with the multi-chain kernels
(`nuts_batched` on batch-major densities, `nuts_batched_t` on transposed
ones) and the per-chain ones (`nuts`, `hmc` on per-example densities,
lifted to the chain block by `model.as_batched`); `sample_with_kernel`
also routes 'chees' to chees.run_chees.

The JAX package runs the whole run as one `lax.scan`; here the transitions
are a host loop, and every random draw comes from one `torch.Generator` on
the state's device (JAX's `key` arguments are `generator` arguments).
Adaptation statistics stay on the device: a transition reads nothing back
to the host beyond the tree loops' conditions (hmc_batched.SYNCS). The
state checkpoints through shard/checkpoint.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .adapt import (
    StepSizeAdaptState,
    WelfordState,
    build_schedule,
    stepsize_init,
    stepsize_init_like,
    stepsize_update,
    welford_cov_init,
    welford_cov_update_batch,
    welford_covariance,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from .hmc_batched import _batched_logp_and_grad, hmc_kernel_batched, nuts_kernel_batched
from .model import as_batched


class SamplerState(NamedTuple):
    """The sampler's state between transitions."""

    generator: torch.Generator
    q: torch.Tensor  # (chains, dim)
    logp: torch.Tensor  # (chains,)
    grad: torch.Tensor  # (chains, dim)
    eps: torch.Tensor  # scalar step size (shared across chains)
    inv_mass: torch.Tensor  # (dim,) diagonal or (dim, dim) dense inverse mass
    ss: StepSizeAdaptState
    welford: WelfordState
    iteration: int


class RunStats(NamedTuple):
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    n_steps: torch.Tensor
    tree_depth: torch.Tensor


def init_sampler(
    logdensity_fn, generator, q0, eps0: float = 0.1, metric: str = "diag",
    batched: bool = False, inv_mass0=None,
) -> SamplerState:
    """q0: (chains, dim) initial positions. metric: 'diag' (Welford
    variance) or 'dense' (full covariance, Stan's dense_e). batched:
    `logdensity_fn` maps (chains, dim) -> (chains,) directly; otherwise it
    is a per-example density, lifted by `as_batched`. The density's
    `value_and_grad_fn`, where it has one, gives the initial logp and
    gradient, so they come from the same density definition as every
    leapfrog's. inv_mass0 seeds the initial inverse mass ((dim,) for diag,
    (dim, dim) for dense) instead of the identity."""
    dtype, dev = q0.dtype, q0.device
    dim = q0.shape[-1]
    if metric == "diag":
        inv_mass = torch.ones(dim, dtype=dtype, device=dev)
        wf = welford_init(dim, dtype, dev)
    elif metric == "dense":
        inv_mass = torch.eye(dim, dtype=dtype, device=dev)
        wf = welford_cov_init(dim, dtype, dev)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if inv_mass0 is not None:
        inv_mass0 = torch.as_tensor(inv_mass0, dtype=dtype, device=dev)
        if inv_mass0.shape != inv_mass.shape:
            raise ValueError(
                f"inv_mass0 shape {tuple(inv_mass0.shape)} does not match the "
                f"{metric!r} metric shape {tuple(inv_mass.shape)}"
            )
        inv_mass = inv_mass0
    if not batched:
        logdensity_fn = as_batched(logdensity_fn)
    logp, grad = _batched_logp_and_grad(logdensity_fn)(q0)
    return SamplerState(
        generator=generator,
        q=q0,
        logp=logp,
        grad=grad,
        eps=torch.tensor(eps0, dtype=dtype, device=dev),
        inv_mass=inv_mass,
        ss=stepsize_init(eps0, dtype, dev),
        welford=wf,
        iteration=0,
    )


def _build_vkernel(logdensity_fn, kernel: str, max_depth: int, n_leapfrog: int = 32):
    """(vkernel, init_logdensity) for a kernel name, shared by
    warmup_and_sample and resume_sampling (same settings give the same
    transitions). 'nuts' and 'hmc': `logdensity_fn` is per-example, and
    the chains run as one block of the batched kernels on its
    `as_batched` lift (the JAX package vmaps its C = 1 kernels: the same
    transition in distribution). 'nuts_batched': `logdensity_fn` maps
    (chains, dim) -> (chains,) (Model.batched_logdensity_fn) and the state
    stays batch-major. 'nuts_batched_t': `logdensity_fn` maps (dim, chains)
    -> (chains,) (Model.batched_logdensity_t_fn), and the state is
    transposed at the transition boundary."""
    if kernel == "nuts":
        return nuts_kernel_batched(as_batched(logdensity_fn), max_depth=max_depth), logdensity_fn
    if kernel == "hmc":
        return (hmc_kernel_batched(as_batched(logdensity_fn), n_leapfrog=n_leapfrog),
                logdensity_fn)
    if kernel == "nuts_batched":
        return nuts_kernel_batched(logdensity_fn, max_depth=max_depth), logdensity_fn
    if kernel != "nuts_batched_t":
        raise ValueError(f"unknown kernel {kernel!r}")
    step_kernel = nuts_kernel_batched(logdensity_fn, max_depth=max_depth, transposed=True)

    def vkernel(generator, q, lp, g, eps, im):
        q1t, lp1, g1t, info = step_kernel(
            generator, q.T.contiguous(), lp, g.T.contiguous(), eps, im
        )
        return q1t.T, lp1, g1t.T, info

    def init_logdensity(q):
        return logdensity_fn(q.T.contiguous())

    vg = getattr(logdensity_fn, "value_and_grad_fn", None)
    if vg is not None:

        def _init_vg(q):
            lp, g = vg(q.T.contiguous())
            return lp, g.T

        init_logdensity.value_and_grad_fn = _init_vg
    return vkernel, init_logdensity


def _stats(info) -> RunStats:
    return RunStats(info.accept_prob, info.diverging, info.n_steps, info.tree_depth)


def _stack(stats, q) -> RunStats:
    """RunStats of (n, chains) from n per-transition stats; with n = 0, empty
    stats of the kernel's dtypes for the chains of q (chains, dim)."""
    if not stats:
        return RunStats(*(
            torch.empty((0, q.shape[0]), dtype=dt, device=q.device)
            for dt in (q.dtype, torch.bool, torch.int32, torch.int32)
        ))
    return RunStats(*(torch.stack(f) for f in zip(*stats)))


def _run_sampling(vkernel, state: SamplerState, n_samples: int, thin: int):
    """The post-warmup sampling loop, shared by warmup_and_sample and
    resume_sampling so that a resumed run repeats the tail of an
    uninterrupted one: (samples (n_samples // thin, chains, dim), final
    state, RunStats of (n_kept, chains))."""

    def step(state):
        q, logp, grad, info = vkernel(
            state.generator, state.q, state.logp, state.grad, state.eps, state.inv_mass
        )
        return state._replace(q=q, logp=logp, grad=grad, iteration=state.iteration + 1), info

    samples, stats = [], []
    if thin <= 1:
        for _ in range(n_samples):
            state, info = step(state)
            samples.append(state.q)
            stats.append(_stats(info))
    else:
        for _ in range(n_samples // thin):
            block = []
            for _ in range(thin):
                state, info = step(state)
                block.append(_stats(info))
            block = _stack(block, state.q)
            # aggregate over the thin block: subsampling would silently
            # discard divergences from the skipped transitions
            stats.append(RunStats(
                accept_prob=torch.mean(block.accept_prob, dim=0),
                diverging=torch.any(block.diverging, dim=0),
                n_steps=torch.sum(block.n_steps, dim=0),
                tree_depth=torch.amax(block.tree_depth, dim=0),
            ))
            samples.append(state.q)
    if not samples:
        return state.q.new_empty((0,) + tuple(state.q.shape)), state, _stack(stats, state.q)
    return torch.stack(samples), state, _stack(stats, state.q)


def resume_sampling(
    logdensity_fn, state: SamplerState, n_samples: int, kernel: str = "nuts_batched_t",
    max_depth: int = 10, n_leapfrog: int = 32, thin: int = 1,
):
    """Continue post-warmup sampling from a SamplerState, e.g. the state a
    warmup_and_sample run with n_samples=0 returns. With the same density
    and kernel settings, the continuation repeats the tail of an
    uninterrupted warmup_and_sample run draw for draw (the state carries
    its generator; shard/checkpoint.py's `load_sampler_state` restores
    one). Returns (samples, state, stats) like warmup_and_sample."""
    vkernel, _ = _build_vkernel(logdensity_fn, kernel, max_depth, n_leapfrog)
    return _run_sampling(vkernel, state, n_samples, thin)


def warmup_and_sample(
    logdensity_fn,
    generator,
    q0,
    n_warmup: int = 500,
    n_samples: int = 500,
    kernel: str = "nuts_batched_t",
    max_depth: int = 10,
    n_leapfrog: int = 32,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    thin: int = 1,
    metric: str = "diag",
    inv_mass0=None,
):
    """Windowed-adaptation warmup (dual-averaged step size on the
    cross-chain mean acceptance, Welford variance in the mass windows, the
    step-size adaptation restarted after each metric refresh), then
    sampling at the dual-averaged step size. metric='dense' adapts the
    full covariance instead of the variance (the leapfrog's products at
    float32's full precision on the card: hmc.py).

    Returns (samples (n_samples // thin, chains, dim), SamplerState,
    RunStats)."""
    vkernel, init_logdensity = _build_vkernel(logdensity_fn, kernel, max_depth, n_leapfrog)
    state = init_sampler(
        init_logdensity, generator, q0, eps0, metric=metric,
        batched=kernel.startswith("nuts_batched"), inv_mass0=inv_mass0,
    )
    window_id, window_end = build_schedule(n_warmup)
    dim, dtype, dev = q0.shape[-1], q0.dtype, q0.device
    dense = metric == "dense"
    wf_update = welford_cov_update_batch if dense else welford_update_batch
    wf_estimate = welford_covariance if dense else welford_variance
    wf_fresh = welford_cov_init if dense else welford_init
    for wid, wend in zip(window_id, window_end):
        q, logp, grad, info = vkernel(
            state.generator, state.q, state.logp, state.grad, state.eps, state.inv_mass
        )
        # step size: dual averaging on the cross-chain mean accept prob
        ss = stepsize_update(state.ss, torch.mean(info.accept_prob), target=target_accept)
        eps = torch.exp(ss.log_eps)
        # mass: Welford inside mass windows; refresh + reset at window ends
        wf = wf_update(state.welford, q) if wid >= 0 else state.welford
        inv_mass = state.inv_mass
        if wend:
            refresh = wf.count > 2
            inv_mass = torch.where(refresh, wf_estimate(wf), inv_mass)
            fresh = wf_fresh(dim, dtype, dev)
            wf = WelfordState(*(torch.where(refresh, a, b) for a, b in zip(fresh, wf)))
            # restart step-size adaptation after a metric refresh (Stan)
            ss = StepSizeAdaptState(
                *(torch.where(refresh, a, b) for a, b in zip(stepsize_init_like(eps, ss), ss))
            )
        state = SamplerState(
            state.generator, q, logp, grad, eps, inv_mass, ss, wf, state.iteration + 1
        )
    # final step size: the dual-averaged value
    state = state._replace(eps=torch.exp(state.ss.log_eps_bar))
    return _run_sampling(vkernel, state, n_samples, thin)


def sample_with_kernel(
    logdensity_fn, generator, q0, n_warmup, n_samples, kernel="nuts_batched",
    **kwargs,
):
    """The one place engine names are routed (Model.sample dispatches
    through here): any warmup_and_sample kernel name, plus 'chees' ->
    chees.run_chees. ChEES adapts its own mass matrix from scratch, so a
    warm-start `inv_mass0` (a warmup_and_sample keyword) is dropped for
    it."""
    if kernel == "chees":
        from .chees import run_chees

        kwargs.pop("inv_mass0", None)
        return run_chees(
            logdensity_fn, generator, q0, n_warmup=n_warmup, n_samples=n_samples,
            **kwargs,
        )
    return warmup_and_sample(
        logdensity_fn, generator, q0, n_warmup=n_warmup, n_samples=n_samples,
        kernel=kernel, **kwargs,
    )
