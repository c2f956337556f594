"""Chain-parallel NUTS, ChEES, Pathfinder, ADVI, tempering and
particle-parallel SMC over `torch.distributed`, PyTorch counterpart of
`tpu_bijectors/shard/chain_parallel.py`.

Chains (particles, paths, Monte-Carlo draws) are the data-parallel axis:
each rank of a process group runs its own block, and the only traffic
between ranks is

  * the adaptation statistics: the dual-averaging acceptance and the
    Welford mean and M2 (NUTS), the ChEES gradient and harmonic
    acceptance, ADVI's loss and gradient, tempering's swap and
    thermodynamic-integration means: one `all_reduce` each, inside the
    engines' transitions (their `group` argument, the JAX package's
    `axis_name`);
  * SMC's resampling: the log weights and the particles `all_gather`ed,
    then a global systematic pick;
  * Pathfinder's pooled draws and weights, gathered once.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims
(`make_mesh`); a runner's `axis_name` picks the process group of that dim.
Where the JAX package takes the global array and shards it, a rank here
passes its own block (`shard_chains`) and gets its own results back;
`gather_chains` all-gathers them where a caller wants the global array.
Each rank draws from its own stream (`infer.sampler.fold_rank`), rank 0
from the caller's generator, so that a run on a one-rank group repeats the
unsharded run bit for bit; every rank passes a generator of the same
state. ADVI's draws and SMC's resampling uniforms come from that shared
state on every rank, as the JAX package's replicated key does.

Multi-host: `multihost_init` wraps `init_process_group` from torchrun's
environment. The backend follows the device, NCCL for CUDA and gloo for
the CPU, unless the caller names one; gloo also serves CUDA tensors, its
all-gather through the host.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..infer.adapt import group_size, psum
from ..infer.sampler import fold_rank, resume_sampling, warmup_and_sample
from ..infer.smc import _systematic_resample


def multihost_init(**kwargs):
    """Initialize the default process group from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, or an `init_method`
    given); a no-op if one is initialized. The backend defaults to NCCL
    where CUDA is available, else gloo."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)


def make_mesh(axis_name="chain", devices=None, shape=None) -> DeviceMesh:
    """A mesh over every rank of the default group: one named dim
    (`axis_name` a name), or several (a tuple of names and their `shape`,
    e.g. ("chain", "param") and (2, 2)). `devices` is the mesh's device
    type, by default "cuda" under NCCL and "cpu" under gloo (which serves
    CUDA tensors too)."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(shape)
    device_type = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def _check(n: int, n_dev: int, what: str = "n_chains"):
    if n % n_dev:
        raise ValueError(f"{what}={n} not divisible by mesh size {n_dev}")


def shard_chains(mesh: DeviceMesh, x, axis_name: str = "chain"):
    """This rank's block of a (chains, ...) array: the chain axis cut into
    equal contiguous blocks over the mesh dim `axis_name`, in rank order."""
    n_dev = group_size(mesh.get_group(axis_name))
    _check(x.shape[0], n_dev)
    n = x.shape[0] // n_dev
    r = mesh.get_local_rank(axis_name)
    return x[r * n:(r + 1) * n].contiguous()


def _all_gather(x, group):
    """The ranks' x (each of the same shape) stacked on a new leading axis,
    in rank order. Gloo gathers CUDA tensors through the host."""
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.detach().cpu() if via_host else x.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(x.device)


def gather_chains(mesh: DeviceMesh, x, axis_name: str = "chain", dim: int = 0):
    """The global array of the ranks' blocks x along `dim` (the inverse of
    `shard_chains`), on every rank."""
    return torch.cat(list(_all_gather(x, mesh.get_group(axis_name)).unbind(0)), dim=dim)


def _pmax(x, group):
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _same_state(generator):
    """A new generator on `generator`'s device in its state: a stream every
    rank draws alike, the caller's generator not advanced."""
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


# ---------------------------------------------------------------------------
# NUTS and its checkpoint resume
# ---------------------------------------------------------------------------


def build_nuts_sharded(
    logdensity_fn,
    mesh: DeviceMesh,
    n_chains: int,
    axis_name: str = "chain",
    **kwargs,
):
    """The chain-parallel NUTS program (generator, q0 block) -> (samples,
    state, stats) of this rank, for `n_chains` chains over the mesh dim
    (kwargs forwarded to warmup_and_sample)."""
    group = mesh.get_group(axis_name)
    _check(n_chains, group_size(group))

    def run(generator, q0_local):
        return warmup_and_sample(logdensity_fn, generator, q0_local, group=group, **kwargs)

    return run


def chain_parallel_nuts(
    logdensity_fn,
    mesh: DeviceMesh,
    generator,
    q0,
    axis_name: str = "chain",
    **kwargs,
):
    """warmup_and_sample on this rank's block q0 (n_chains / n_ranks, dim)
    (`shard_chains`), the adaptation shared across the ranks of the mesh
    dim: the step size and inverse mass come out the same on every rank.
    Returns this rank's (samples, SamplerState, RunStats)."""
    n = q0.shape[0] * group_size(mesh.get_group(axis_name))
    return build_nuts_sharded(logdensity_fn, mesh, n, axis_name=axis_name, **kwargs)(
        generator, q0)


def build_resume_sharded(
    logdensity_fn,
    mesh: DeviceMesh,
    n_samples: int,
    axis_name: str = "chain",
    **kwargs,
):
    """The resume program (this rank's SamplerState) -> (samples, state,
    stats) (kwargs forwarded to resume_sampling). Sampling shares nothing
    across ranks; the mesh only names them."""
    def run(state):
        return resume_sampling(logdensity_fn, state, n_samples, **kwargs)

    return run


def chain_parallel_resume(
    logdensity_fn,
    mesh: DeviceMesh,
    state,
    n_samples: int,
    axis_name: str = "chain",
    **kwargs,
):
    """Continue post-warmup sampling from this rank's SamplerState, e.g.
    its own checkpoint (`shard/checkpoint.py`: the state holds its
    generator's `get_state()`): the preemption-recovery path. With the
    same kernel settings the continuation repeats the tail of an
    uninterrupted chain_parallel_nuts run bit for bit."""
    if state.q.ndim != 2:
        raise ValueError(f"the state's q must be (chains, dim); got {tuple(state.q.shape)}")
    return build_resume_sharded(logdensity_fn, mesh, n_samples, axis_name, **kwargs)(state)


# ---------------------------------------------------------------------------
# ChEES, Pathfinder, ADVI
# ---------------------------------------------------------------------------


def chain_parallel_chees(
    logdensity_fn,
    mesh: DeviceMesh,
    generator,
    q0,
    axis_name: str = "chain",
    **kwargs,
):
    """run_chees on this rank's block q0: the ChEES gradient, the harmonic
    acceptance and the Welford mass are shared across the ranks inside the
    warmup transitions, so every rank runs the same number of leapfrogs a
    transition. Returns this rank's (samples, CheesState, CheesStats)."""
    from ..infer.chees import run_chees

    group = mesh.get_group(axis_name)
    return run_chees(logdensity_fn, fold_rank(generator, group), q0, group=group, **kwargs)


def chain_parallel_pathfinder(
    logdensity_fn,
    mesh: DeviceMesh,
    generator,
    v0s,
    n_draws: int = 1000,
    per_path_draws: int = 200,
    axis_name: str = "chain",
    **kwargs,
):
    """Multi-path Pathfinder with the paths sharded: each rank runs its
    block of paths from its starts v0s (`shard_chains` of the (n_paths,
    dim) starts) on its own stream, then the pooled draws and their log
    importance weights are gathered once, and rank 0 resamples the global
    pool with truncated importance weights and hands its picks to every
    rank. On one rank this is `infer.multipath_pathfinder` bit for bit.
    Returns (draws (n_draws, dim), the same on every rank; this rank's
    PathfinderResult stack). kwargs: max_iters, history, n_elbo_mc,
    optimizer."""
    from ..infer.pathfinder import (
        PathfinderResult,
        _normal,
        _results,
        _truncated_log_weights,
    )

    group = mesh.get_group(axis_name)
    g = fold_rank(generator, group)
    dim = v0s.shape[-1]
    res = _results(logdensity_fn, _normal(g, v0s), v0s, kwargs.pop("max_iters", 60),
                   kwargs.pop("history", 6), kwargs.pop("n_elbo_mc", 30), per_path_draws,
                   kwargs.pop("optimizer", None))
    if kwargs:
        raise TypeError(f"unexpected arguments {sorted(kwargs)}")
    res = PathfinderResult(*(torch.stack(t) for t in zip(*res)))
    pool = _all_gather(res.draws.reshape(-1, dim), group).reshape(-1, dim)
    logw = _all_gather((res.logp - res.logq).reshape(-1), group).reshape(-1)
    if dist.get_rank(group) == 0:
        logw_t = _truncated_log_weights(logw)
        take = torch.multinomial(torch.softmax(logw_t, dim=0), n_draws, replacement=True,
                                 generator=g)
    else:
        take = torch.empty(n_draws, dtype=torch.int64, device=v0s.device)
    dist.broadcast(take, src=dist.get_global_rank(group, 0), group=group)
    return pool[take], res


def build_advi_sharded(
    logdensity_fn,
    mesh: DeviceMesh,
    dim: int,
    q,
    axis_name: str = "chain",
    **kwargs,
):
    """The MC-sharded ADVI program (generator, q) -> ADVIResult (kwargs
    forwarded to fit_advi; n_mc divisible by the ranks)."""
    from ..infer.advi import fit_advi

    group = mesh.get_group(axis_name)
    _check(kwargs.get("n_mc", 32), group_size(group), "n_mc")

    def run(generator, q):
        return fit_advi(logdensity_fn, generator, dim, q=q, group=group, **kwargs)

    return run


def chain_parallel_advi(
    logdensity_fn,
    mesh: DeviceMesh,
    generator,
    dim: int,
    q=None,
    axis_name: str = "chain",
    **kwargs,
):
    """fit_advi with the Monte-Carlo batch sharded: every rank draws the
    full (n_mc, dim) block from a generator of the same state, evaluates
    the density on its slice, and the loss and gradient are averaged over
    the ranks inside each step. q and the optimiser state stay the same on
    every rank, so the whole trajectory equals the unsharded fit_advi's up
    to the order of the sums. Works with every family and estimator
    fit_advi takes (transposed=True for the whole-model kernels). Returns
    the ADVIResult, the same on every rank."""
    from ..infer.advi import MeanFieldGaussian

    if q is None:
        q = MeanFieldGaussian.init(dim, kwargs.get("dtype", torch.float32),
                                   kwargs.get("device"))
    return build_advi_sharded(logdensity_fn, mesh, dim, q, axis_name=axis_name, **kwargs)(
        generator, q)


# ---------------------------------------------------------------------------
# Particle-parallel SMC
# ---------------------------------------------------------------------------


def distributed_systematic_resample(generator, log_weights_local, group):
    """Global systematic resampling with the particles split over the ranks
    of `group`: the log weights are all-gathered, the global parents drawn
    with one uniform from `generator` (of the same state on every rank),
    and this rank's slice of them returned: indices into the global
    particle array."""
    n_local = log_weights_local.shape[0]
    lw = _all_gather(log_weights_local, group).reshape(-1)
    u0 = torch.rand((), generator=generator, dtype=lw.dtype, device=lw.device)
    parents = _systematic_resample(lw, u0)
    r = dist.get_rank(group)
    return parents[r * n_local:(r + 1) * n_local]


def build_smc_sharded(
    log_prior_fn,
    log_lik_fn,
    mesh: DeviceMesh,
    n: int,
    dim: int,
    axis_name: str = "chain",
    n_mutations: int = 5,
    target_ess: float = 0.5,
    max_stages: int = 50,
    rw_scale: float = 0.3,
):
    """The particle-parallel tempered-SMC program (generator, this rank's
    particles (n / n_ranks, dim)) -> (particles, log_evidence, beta,
    stages): the next beta by bisection on the global ESS, resampling over
    the gathered weights and particles, random-walk mutation on the local
    block. The stage loop reads beta once a stage, the same on every
    rank."""
    from ..infer.model import as_batched

    group = mesh.get_group(axis_name)
    n_dev = group_size(group)
    _check(n, n_dev, "particles")
    blp, bll = as_batched(log_prior_fn), as_batched(log_lik_fn)

    def ess_global(lw):
        m = _pmax(torch.max(lw), group)
        w = torch.exp(lw - m)
        s1, s2 = psum(torch.sum(w), group), psum(torch.sum(w * w), group)
        return s1 * s1 / s2

    def next_beta(ll, beta):
        target = target_ess * n
        one = torch.ones_like(beta)
        lo, hi = beta, one
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            ok = ess_global((mid - beta) * ll) >= target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        nb = torch.where(ess_global((1.0 - beta) * ll) >= target, one, lo)
        # strict progress (infer/smc.py::_find_next_beta)
        return torch.clamp_max(torch.maximum(nb, beta + 1e-6), 1.0)

    def mutate(g, parts, beta):
        def f(v):
            return blp(v) + beta * bll(v)

        lp = f(parts)
        for _ in range(n_mutations):
            prop = parts + rw_scale * torch.randn(parts.shape, generator=g, dtype=parts.dtype,
                                                  device=parts.device)
            lp_prop = f(prop)
            u = torch.rand(parts.shape[0], generator=g, dtype=parts.dtype, device=parts.device)
            acc = torch.log(u) < lp_prop - lp
            parts = torch.where(acc[:, None], prop, parts)
            lp = torch.where(acc, lp_prop, lp)
        return parts

    @torch.no_grad()
    def run(generator, parts):
        g_mut, g_res = fold_rank(generator, group), _same_state(generator)
        zero = torch.zeros((), dtype=parts.dtype, device=parts.device)
        ll, beta, log_ev, it = bll(parts), zero, zero, 0
        while it < max_stages and bool(beta < 1.0):
            nb = next_beta(ll, beta)
            inc = (nb - beta) * ll
            m = _pmax(torch.max(inc), group)
            sum_w = psum(torch.sum(torch.exp(inc - m)), group)
            log_ev = log_ev + m + torch.log(sum_w) - math.log(float(n))
            parents = distributed_systematic_resample(g_res, inc, group)
            parts = _all_gather(parts, group).reshape(-1, dim)[parents]
            parts = mutate(g_mut, parts, nb)
            ll, beta, it = bll(parts), nb, it + 1
        return parts, log_ev, beta, it

    return run


def chain_parallel_smc(
    log_prior_fn,
    log_lik_fn,
    mesh: DeviceMesh,
    generator,
    particles0,
    axis_name: str = "chain",
    **kwargs,
):
    """Tempered SMC with the particles sharded: particles0 is this rank's
    block (`shard_chains`); see build_smc_sharded for the program and
    kwargs. Returns this rank's particles and the shared log evidence,
    final beta and stage count."""
    n_local, dim = particles0.shape
    n = n_local * group_size(mesh.get_group(axis_name))
    return build_smc_sharded(log_prior_fn, log_lik_fn, mesh, n, dim, axis_name=axis_name,
                             **kwargs)(generator, particles0)


def chain_parallel_pt(
    log_prior_fn,
    log_lik_fn,
    mesh: DeviceMesh,
    generator,
    q0,
    axis_name: str = "chain",
    **kwargs,
):
    """Parallel tempering with the chain columns of the (temperatures x
    chains) lattice sharded: q0 is this rank's block; replica exchange
    stays within a column, and only the adaptation, swap and
    thermodynamic-integration means cross the ranks
    (infer.run_parallel_tempering kwargs forwarded). Returns this rank's
    PTResult: its cold-chain draws, the shared statistics."""
    from ..infer.tempering import run_parallel_tempering

    group = mesh.get_group(axis_name)
    return run_parallel_tempering(log_prior_fn, log_lik_fn, fold_rank(generator, group), q0,
                                  group=group, **kwargs)
