"""ChEES-HMC, PyTorch counterpart of `tpu_bijectors/infer/chees.py`:
gradient-based trajectory-length adaptation (Hoffman & Sountsov, AISTATS
2021).

Every chain runs the same number of leapfrog steps a transition (one
jittered trajectory length is shared), so the whole chain block marches in
lockstep: the batch-major density and its gradient are evaluated on the
full (chains, dim) block every step, with no masked chains.

The trajectory length T maximizes the ChEES criterion

    ChEES(T) = 1/4 E[(||q' - E q'||^2 - ||q - E q||^2)^2]

by Adam on log T, with the closed-form endpoint derivative dq'/dh = v' (the
velocity after the last leapfrog): the per-transition gradient

    g = E_w[(||q'_c||^2 - ||q_c||^2) * (q'_c . v')] * u * T,

chains weighted by their acceptance probability w, u the transition's
jitter fraction (the van der Corput sequence, as in the paper).

The JAX package runs a `fori_loop` of n_steps = ceil(u T / eps) (clipped
to [1, max_steps]) leapfrogs; here n_steps is read to the host once a
transition (`hmc_batched.SYNCS['trajectory']`) and exactly that many
leapfrogs run. Every draw comes from the state's `torch.Generator`.

With a `group` (`shard.chain_parallel_chees`), the chain means of the
ChEES gradient, the harmonic acceptance and the Welford statistics are
means over every rank's chains (one `all_reduce` each): the adapted step
size and trajectory length come out the same on every rank, so the ranks'
chain blocks march in lockstep too.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .adapt import (
    StepSizeAdaptState,
    WelfordState,
    build_schedule,
    pmean,
    stepsize_init,
    stepsize_update,
    welford_cov_init,
    welford_cov_update_batch,
    welford_covariance,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from .hmc import (
    MAX_ENERGY_DELTA,
    IntegratorState,
    apply_inv_mass,
    kinetic,
    leapfrog,
    momentum_from_z,
)
from .hmc_batched import SYNCS, _batched_logp_and_grad
from .model import as_batched


def _halton2(i: int) -> float:
    """Van der Corput base-2 sequence in (0, 1): the bit reversal of i + 1
    over 24 bits, the low-discrepancy trajectory jitter the paper
    recommends. Exact in float32."""
    return sum((((i + 1) >> k) & 1) * 0.5 ** (k + 1.0) for k in range(24))


class CheesState(NamedTuple):
    """The ChEES sampler's state (checkpointable as SamplerState is)."""

    generator: torch.Generator
    q: torch.Tensor  # (chains, dim)
    logp: torch.Tensor
    grad: torch.Tensor
    eps: torch.Tensor
    log_t: torch.Tensor  # log trajectory length
    inv_mass: torch.Tensor  # (dim,) diagonal or (dim, dim) dense
    ss: StepSizeAdaptState
    welford: WelfordState
    adam_m: torch.Tensor  # Adam first and second moments of log_t
    adam_v: torch.Tensor
    iteration: int


class CheesStats(NamedTuple):
    accept_prob: torch.Tensor  # (iters, chains)
    diverging: torch.Tensor  # (iters, chains) energy error > MAX_ENERGY_DELTA
    n_steps: torch.Tensor  # (iters,)
    trajectory: torch.Tensor  # (iters,) T a transition


def _chees_grad(q, q1, v_end, w, u: float, t, group=None):
    """d ChEES / d log T from the proposed endpoints q1 and their velocity
    v_end, chains weighted by w, the means over `group`'s ranks too. A
    divergent chain has non-finite q1 or v_end: its weight is 0 already,
    but 0 * inf = NaN would poison the Adam moments for good, so its term
    is masked itself."""
    qc_old = q - pmean(torch.mean(q, dim=0), group)
    qc_new = q1 - pmean(torch.mean(q1, dim=0), group)
    term = torch.sum(qc_new * qc_new, dim=-1) - torch.sum(qc_old * qc_old, dim=-1)
    per_chain = term * torch.sum(qc_new * v_end, dim=-1)
    per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0)
    g = pmean(torch.mean(w * per_chain), group) / torch.clamp_min(
        pmean(torch.mean(w), group), 1e-10)
    return g * u * t  # chain rule: dh / dlog T = u T


def _adam_log_t(st: CheesState, g_logt, eps, lr_t: float, max_steps: int):
    """One Adam ascent step on log T, clipped into [log eps,
    log(0.9 max_steps eps)]: (log_t, m, v)."""
    m = 0.9 * st.adam_m + 0.1 * g_logt
    v = 0.999 * st.adam_v + 0.001 * g_logt**2
    tf = float(st.iteration + 1)
    mhat = m / (1.0 - 0.9**tf)
    vhat = v / (1.0 - 0.999**tf)
    log_t = st.log_t + lr_t * mhat / (torch.sqrt(vhat) + 1e-8)
    log_t = torch.minimum(torch.maximum(log_t, torch.log(eps)),
                          torch.log(0.9 * max_steps * eps))
    return log_t, m, v


def _transition(vg, q, logp, grad, eps, t, inv_mass, u: float, z, u_acc, max_steps: int,
                group=None):
    """One lockstep jittered trajectory for the whole chain block, given the
    momentum's standard normal z (chains, dim) and the accept uniforms
    u_acc (chains,): (q', logp', grad', accept_prob, diverging, harmonic
    mean accept, d ChEES / d log T, n_steps as a 0-d int32 tensor)."""
    n_steps = torch.clamp(torch.ceil(u * t / eps), 1, max_steps).to(torch.int32)
    SYNCS["trajectory"] += 1
    n = int(n_steps)
    p0 = momentum_from_z(z, inv_mass)
    energy0 = -logp + kinetic(p0, inv_mass)
    s1 = IntegratorState(q, p0, logp, grad)
    for _ in range(n):
        s1 = leapfrog(vg, s1, eps, inv_mass)
    delta = -s1.logp + kinetic(s1.p, inv_mass) - energy0
    finite = torch.isfinite(delta)
    diverging = ~finite | (delta > MAX_ENERGY_DELTA)
    accept_prob = torch.where(
        finite, torch.clamp_max(torch.exp(torch.clamp_max(-delta, 0.0)), 1.0), 0.0
    )
    accept = u_acc < accept_prob
    g_logt = _chees_grad(q, s1.q, apply_inv_mass(inv_mass, s1.p), accept_prob, u, t, group)
    q1 = torch.where(accept[:, None], s1.q, q)
    logp1 = torch.where(accept, s1.logp, logp)
    grad1 = torch.where(accept[:, None], s1.grad, grad)
    harm_acc = 1.0 / pmean(torch.mean(1.0 / torch.clamp_min(accept_prob, 1e-10)), group)
    return q1, logp1, grad1, accept_prob, diverging, harm_acc, g_logt, n_steps


def _draws(st: CheesState):
    """A transition's draws from the state's generator: z, then u_acc."""
    q = st.q
    z = torch.randn(q.shape, generator=st.generator, dtype=q.dtype, device=q.device)
    u_acc = torch.rand(q.shape[0], generator=st.generator, dtype=q.dtype, device=q.device)
    return z, u_acc


def _warmup_step(vg, st: CheesState, wid: int, wend: bool, z, u_acc, *, dense: bool,
                 target_accept: float, lr_t: float, max_steps: int, group=None):
    """One warmup transition given its draws, then the step-size, trajectory
    and mass adaptation (shared across `group`'s ranks): (state,
    (accept_prob, diverging, n_steps, T))."""
    dtype = st.q.dtype
    u = _halton2(st.iteration)
    t = torch.exp(st.log_t)
    q1, logp1, grad1, acc, div, harm_acc, g_logt, n_steps = _transition(
        vg, st.q, st.logp, st.grad, st.eps, t, st.inv_mass, u, z, u_acc, max_steps, group
    )
    ss = stepsize_update(st.ss, harm_acc, target=target_accept)
    eps = torch.exp(ss.log_eps).to(dtype)
    log_t, m, v = _adam_log_t(st, g_logt, eps, lr_t, max_steps)
    # windowed Welford mass (diagonal variance or dense covariance)
    wf = st.welford
    if wid >= 0:
        wf = (welford_cov_update_batch if dense else welford_update_batch)(wf, q1, group)
    inv_mass = st.inv_mass
    if wend:
        inv_mass = (welford_covariance if dense else welford_variance)(wf).to(dtype)
        wf = (welford_cov_init if dense else welford_init)(q1.shape[-1], dtype, q1.device)
    st = CheesState(st.generator, q1, logp1, grad1, eps, log_t, inv_mass, ss, wf, m, v,
                    st.iteration + 1)
    return st, (acc, div, n_steps, torch.exp(log_t))


def _sample_step(vg, st: CheesState, z, u_acc, max_steps: int):
    """One sampling transition at the tuned eps and T, given its draws."""
    t = torch.exp(st.log_t)
    q1, logp1, grad1, acc, div, _, _, n_steps = _transition(
        vg, st.q, st.logp, st.grad, st.eps, t, st.inv_mass, _halton2(st.iteration), z, u_acc,
        max_steps,
    )
    st = st._replace(q=q1, logp=logp1, grad=grad1, iteration=st.iteration + 1)
    return st, (q1, acc, div, n_steps, t)


def _init_state(vg, generator, q0, eps0: float, dense: bool) -> CheesState:
    dtype, dev = q0.dtype, q0.device
    dim = q0.shape[-1]
    logp, grad = vg(q0)

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    return CheesState(
        generator, q0, logp, grad, scalar(eps0), scalar(math.log(10.0 * eps0)),
        torch.eye(dim, dtype=dtype, device=dev) if dense
        else torch.ones(dim, dtype=dtype, device=dev),
        stepsize_init(eps0, dtype, dev),
        (welford_cov_init if dense else welford_init)(dim, dtype, dev),
        scalar(0.0), scalar(0.0), 0,
    )


def run_chees(
    logdensity_fn,
    generator,
    q0,
    n_warmup: int = 500,
    n_samples: int = 500,
    eps0: float = 0.1,
    target_accept: float = 0.651,
    lr_t: float = 0.05,
    max_steps: int = 1024,
    metric: str = "diag",
    group=None,
):
    """Warmup (step size, trajectory and mass adaptation) then sampling with
    the tuned jittered-trajectory HMC. Accepts per-example or batch-capable
    (`fn.batch_capable`) log densities on batch-major (chains, dim) states
    (`model.as_batched`); a density's `value_and_grad_fn` serves every
    leapfrog where it has one. metric: 'diag' (Welford variance) or 'dense'
    (full covariance, Stan's dense_e: the NUTS warmup's accumulators).
    Every draw comes from `generator` (on q0's device). With `group`, q0
    is this rank's block of chains and the adaptation is shared across the
    group's ranks (the module docstring); the sampling transitions share
    nothing. Returns (samples (n_samples, chains, dim), CheesState,
    CheesStats)."""
    if metric not in ("diag", "dense"):
        raise ValueError(f"unknown metric {metric!r}")
    dense = metric == "dense"
    vg = _batched_logp_and_grad(as_batched(logdensity_fn))
    st = _init_state(vg, generator, q0, eps0, dense)
    window_id, window_end = build_schedule(n_warmup)
    for wid, wend in zip(window_id, window_end):
        st, _ = _warmup_step(vg, st, int(wid), bool(wend), *_draws(st), dense=dense,
                             target_accept=target_accept, lr_t=lr_t, max_steps=max_steps,
                             group=group)
    # sampling at the dual-averaged eps and the tuned T
    st = st._replace(eps=torch.exp(st.ss.log_eps_bar).to(q0.dtype))
    samples, acc, div, n_steps, t_trace = [], [], [], [], []
    for _ in range(n_samples):
        st, (q1, a, d, n, t) = _sample_step(vg, st, *_draws(st), max_steps)
        samples.append(q1)
        acc.append(a)
        div.append(d)
        n_steps.append(n)
        t_trace.append(t)
    if not samples:
        C, dev = q0.shape[0], q0.device
        empty = torch.empty((0,), dtype=q0.dtype, device=dev)
        return (q0.new_empty((0,) + tuple(q0.shape)), st, CheesStats(
            q0.new_empty((0, C)), torch.empty((0, C), dtype=torch.bool, device=dev),
            torch.empty((0,), dtype=torch.int32, device=dev), empty))
    return torch.stack(samples), st, CheesStats(
        torch.stack(acc), torch.stack(div), torch.stack(n_steps), torch.stack(t_trace)
    )
