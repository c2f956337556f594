"""Natively multi-chain NUTS, PyTorch counterpart of
`tpu_bijectors/infer/hmc_batched.py`, in both of its layouts:
batch-major (`transposed=False`, state (chains, dim), `nuts_batched`) and
transposed (`transposed=True`, state (dim, chains), `nuts_batched_t`).

Chains are a real batch axis: per-chain termination is a (chains,) mask,
updates are `where`-gated per chain, and the log-density and its gradient
are evaluated on the whole block of chains per leapfrog, so each kernel of
the density runs once per step (on the transposed layout, the
whole-model fused kernels). The algorithm is the JAX package's:
iterative tree doubling with checkpoint-buffer U-turn checks, multinomial
sampling within a subtree, a biased merge (Betancourt 2017), and chains
that are dead in the outer loop born inert in a subtree. The layouts draw
the momentum in their own shapes, so their trajectories differ; they agree
in distribution.

The JAX package's two `lax.while_loop`s are host loops here. The tree
counter and depth are host ints; each iteration's condition reads one
`any(active)` from the device, and `SYNCS` counts those reads (and the
reads of the other engines' host loops: ChEES's trajectory length, SMC's
stage condition, L-BFGS's line-search trials).

`hmc_kernel_batched` is the fixed-trajectory transition in the same two
layouts (SMC's HMC mutation runs it on whole particle blocks).
"""

from __future__ import annotations

import torch

from .hmc import MAX_ENERGY_DELTA, NutsInfo, _trailing_zeros, apply_inv_mass, momentum_from_z

# device -> host reads: the NUTS tree loops' conditions (`any_active`),
# ChEES's trajectory length a transition (`trajectory`), SMC's stage
# condition (`stage`), L-BFGS's line-search trials (`linesearch`)
SYNCS = {"any_active": 0, "trajectory": 0, "stage": 0, "linesearch": 0}


def reset_sync_count():
    for k in SYNCS:
        SYNCS[k] = 0


def _any(mask) -> bool:
    SYNCS["any_active"] += 1
    return bool(torch.any(mask))


class _Layout:
    """Axis conventions of the tree state (the JAX package's `_Layout`):

    batch-major: state (C, dim); checkpoints (C, S, dim); dim is axis -1.
    transposed:  state (dim, C); checkpoints (S, dim, C); dim is axis -2,
    so a diagonal metric broadcasts as inv_mass[:, None] against the state
    and the checkpoint stack alike, and a dense one multiplies from the
    left."""

    def __init__(self, transposed: bool):
        self.transposed = transposed

    def chains(self, q) -> int:
        return q.shape[1] if self.transposed else q.shape[0]

    def bexp(self, m):
        """(C,) chain mask -> broadcastable against the 2-D state."""
        return m[None, :] if self.transposed else m[:, None]

    def vdot(self, a, b):
        """Inner product over the dim axis of states or checkpoint stacks."""
        return torch.sum(a * b, dim=-2 if self.transposed else -1)

    def aim(self, inv_mass, p):
        """M^{-1} p in this layout for a diagonal (dim,) or dense (dim, dim)
        metric."""
        if not self.transposed:
            return apply_inv_mass(inv_mass, p)
        if inv_mass.ndim == 1:
            return p * inv_mass[:, None]
        return torch.matmul(inv_mass, p)

    def momentum_from_z(self, z, inv_mass):
        """p ~ N(0, M) from a standard normal z of the state's shape."""
        if not self.transposed:
            return momentum_from_z(z, inv_mass)
        if inv_mass.ndim == 1:
            return z / torch.sqrt(inv_mass)[:, None]
        # p = L^{-T} z columnwise, inv_mass = L L' (hmc.momentum_from_z)
        L = torch.linalg.cholesky(inv_mass.to(z.dtype))
        return torch.linalg.solve_triangular(L.T, z, upper=True)

    def momentum(self, generator, q, inv_mass):
        z = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
        return self.momentum_from_z(z, inv_mass)

    def ck_zeros(self, q, S):
        C = self.chains(q)
        dim = q.shape[0] if self.transposed else q.shape[1]
        shape = (S, dim, C) if self.transposed else (C, S, dim)
        return torch.zeros(shape, dtype=q.dtype, device=q.device)

    def slots(self, ck, lo, hi):
        """Checkpoint slots lo..hi-1, as a view."""
        return ck[lo:hi] if self.transposed else ck[:, lo:hi]

    def ck_bcast(self, x):
        """2-D state -> broadcastable against a checkpoint stack."""
        return x[None] if self.transposed else x[:, None]

    def any_slot(self, per_slot):
        """(S, C) or (C, S) -> any over the slots -> (C,)."""
        return torch.any(per_slot, dim=0 if self.transposed else -1)


def _batched_logp_and_grad(logp_batched):
    """(lp (C,), d sum(lp) / dq) of the state: the density's own
    `value_and_grad_fn` where it carries one (Model.batched_logdensity_t_fn:
    the fused one-pass kernel; Model.batched_logdensity_fn: autograd
    through the link kernels), else autograd through the density."""
    vg = getattr(logp_batched, "value_and_grad_fn", None)
    if vg is not None:
        return vg

    def f(q):
        with torch.enable_grad():
            v = q.detach().requires_grad_(True)
            lp = logp_batched(v)
            (g,) = torch.autograd.grad(lp.sum(), v)
        return lp.detach(), g

    return f


def _leapfrog(lg, q, p, grad, eps_dir, inv_mass, aim=apply_inv_mass):
    """One leapfrog step; eps_dir is the signed step size, broadcastable
    against the state ((1, C) or (C, 1)); `aim(inv_mass, p)` is M^{-1} p
    (`_Layout.aim`; by default `apply_inv_mass`, whose diagonal broadcasts
    as given)."""
    p_half = p + 0.5 * eps_dir * grad
    q_new = q + eps_dir * aim(inv_mass, p_half)
    lp_new, g_new = lg(q_new)
    p_new = p_half + 0.5 * eps_dir * g_new
    return q_new, p_new, lp_new, g_new


def nuts_kernel_batched(logp_batched, max_depth: int = 10, transposed: bool = False):
    """(generator, q, logp (C,), grad, eps, inv_mass) -> (q', logp', grad',
    NutsInfo with (C,) fields). transposed=False: q and grad are (C, dim)
    and `logp_batched` maps (C, dim) -> (C,) (e.g.
    Model.batched_logdensity_fn). transposed=True: q and grad are (dim, C)
    and `logp_batched` maps (dim, C) -> (C,) (e.g.
    Model.batched_logdensity_t_fn). `eps` is a scalar (0-d tensor),
    `inv_mass` a diagonal (dim,) or dense (dim, dim) metric. The velocity
    M^{-1} p is what the checkpoints keep, so a dense metric costs one
    (dim, dim) product a leapfrog."""
    lg = _batched_logp_and_grad(logp_batched)
    L = _Layout(transposed)
    _aim = L.aim

    def _pick(mask, a, b):
        # where(mask, a, b) with a (C,) chain mask against (C,) or a state
        return torch.where(mask if a.ndim == 1 else L.bexp(mask), a, b)

    def build_subtree(edge, direction, depth_j, outer_active, eps, inv_mass,
                      energy0, generator):
        """2^depth_j masked leapfrog steps for every chain at once; chains
        dead in the outer loop start diverging, so the loop ends as soon as
        the live chains finish (the caller gates every returned mask)."""
        sq, sp, slp, sg = edge
        C = L.chains(sq)
        dtype, dev = sq.dtype, sq.device
        n_leaves = 1 << depth_j
        eps_dir = L.bexp(direction * eps)
        ck_q = L.ck_zeros(sq, max_depth + 1)
        ck_v = torch.zeros_like(ck_q)  # velocity (M^{-1} p) checkpoints
        neg_inf = torch.full((C,), -torch.inf, dtype=dtype, device=dev)
        prop_q, prop_logp, prop_grad = torch.zeros_like(sq), neg_inf, torch.zeros_like(sq)
        log_w = neg_inf
        turning = torch.zeros(C, dtype=torch.bool, device=dev)
        diverging = ~outer_active
        sum_acc = torch.zeros(C, dtype=dtype, device=dev)
        n_steps = torch.zeros(C, dtype=torch.int32, device=dev)
        n = 0
        while n < n_leaves and _any(~(turning | diverging)):
            active = ~(turning | diverging)
            am = L.bexp(active)
            nq, np_, nlp, ng = _leapfrog(lg, sq, sp, sg, eps_dir, inv_mass, _aim)
            # inactive chains keep their old state
            nq = torch.where(am, nq, sq)
            np_ = torch.where(am, np_, sp)
            nlp = torch.where(active, nlp, slp)
            ng = torch.where(am, ng, sg)

            nv = _aim(inv_mass, np_)  # velocity, shared by kinetic and U-turn
            energy = -nlp + 0.5 * L.vdot(np_, nv)
            delta = energy - energy0
            div = active & ((delta > MAX_ENERGY_DELTA) | ~torch.isfinite(energy))
            log_w_leaf = torch.where(active & ~div, -delta, neg_inf)
            acc = torch.clamp_max(torch.exp(torch.clamp_max(-delta, 0.0)), 1.0)
            acc = torch.where(active & torch.isfinite(delta), acc, 0.0)

            log_w_new = torch.logaddexp(log_w, log_w_leaf)
            u = torch.rand(C, generator=generator, dtype=dtype, device=dev)
            take = active & (torch.log(u) < (log_w_leaf - log_w_new))
            prop_q = _pick(take, nq, prop_q)
            prop_logp = _pick(take, nlp, prop_logp)
            prop_grad = _pick(take, ng, prop_grad)

            # checkpoints: slots 0..tz take the new state (all at n = 0)
            tz = max_depth if n == 0 else _trailing_zeros(n)
            amc = L.ck_bcast(am)
            for ck, new in ((ck_q, nq), (ck_v, nv)):
                w = L.slots(ck, 0, tz + 1)
                w.copy_(torch.where(amc, L.ck_bcast(new), w))
            # U-turn of the new state against checkpoint slots 1..tz(n+1)
            tz1 = _trailing_zeros(n + 1)
            if tz1 >= 1:
                dq = L.ck_bcast(nq) - L.slots(ck_q, 1, tz1 + 1)
                turn = (L.vdot(dq, L.slots(ck_v, 1, tz1 + 1)) < 0) | (
                    L.vdot(dq, L.ck_bcast(nv)) < 0
                )
                turning = turning | (active & L.any_slot(turn))

            sq, sp, slp, sg = nq, np_, nlp, ng
            log_w = log_w_new
            diverging = diverging | div
            sum_acc = sum_acc + acc
            n_steps = n_steps + active.to(torch.int32)
            n += 1
        return ((sq, sp, slp, sg), prop_q, prop_logp, prop_grad, log_w,
                turning, diverging, sum_acc, n_steps)

    def kernel(generator, q, logp, grad, eps, inv_mass):
        C = L.chains(q)
        dtype, dev = q.dtype, q.device
        p0 = L.momentum(generator, q, inv_mass)
        energy0 = -logp + 0.5 * L.vdot(p0, _aim(inv_mass, p0))
        neg_inf = torch.full((C,), -torch.inf, dtype=dtype, device=dev)

        left = right = (q, p0, logp, grad)
        prop_q, prop_logp, prop_grad = q, logp, grad
        log_w = torch.zeros(C, dtype=dtype, device=dev)
        turning = torch.zeros(C, dtype=torch.bool, device=dev)
        diverging = torch.zeros(C, dtype=torch.bool, device=dev)
        sum_acc = torch.zeros(C, dtype=dtype, device=dev)
        n_steps = torch.zeros(C, dtype=torch.int32, device=dev)
        depth_pc = torch.zeros(C, dtype=torch.int32, device=dev)
        j = 0
        while j < max_depth and _any(~(turning | diverging)):
            active = ~(turning | diverging)
            go_right = torch.rand(C, generator=generator, dtype=dtype, device=dev) < 0.5
            edge = tuple(_pick(go_right, r, l) for l, r in zip(left, right))
            direction = torch.where(go_right, 1.0, -1.0).to(dtype)
            (sub_edge, s_prop_q, s_prop_logp, s_prop_grad, s_log_w, s_turning,
             s_diverging, s_sum_acc, s_n_steps) = build_subtree(
                edge, direction, j, active, eps, inv_mass, energy0, generator
            )
            # the subtree's outermost state extends the tree on its side;
            # inactive chains keep everything
            new_left = tuple(
                _pick(active, _pick(go_right, l, s), l) for l, s in zip(left, sub_edge)
            )
            new_right = tuple(
                _pick(active, _pick(go_right, s, r), r) for r, s in zip(right, sub_edge)
            )
            ok = active & ~s_turning & ~s_diverging
            u = torch.rand(C, generator=generator, dtype=dtype, device=dev)
            accept_new = ok & (torch.log(u) < s_log_w - log_w)
            prop_q = _pick(accept_new, s_prop_q, prop_q)
            prop_logp = _pick(accept_new, s_prop_logp, prop_logp)
            prop_grad = _pick(accept_new, s_prop_grad, prop_grad)
            log_w = torch.logaddexp(log_w, torch.where(ok, s_log_w, neg_inf))
            dq = new_right[0] - new_left[0]
            full_turn = (L.vdot(dq, _aim(inv_mass, new_left[1])) < 0) | (
                L.vdot(dq, _aim(inv_mass, new_right[1])) < 0
            )
            turning = turning | (active & s_turning) | (ok & full_turn)
            diverging = diverging | (active & s_diverging)
            sum_acc = sum_acc + torch.where(active, s_sum_acc, 0.0)
            n_steps = n_steps + torch.where(active, s_n_steps, 0)
            depth_pc = depth_pc + active.to(torch.int32)
            left, right = new_left, new_right
            j += 1

        info = NutsInfo(
            accept_prob=sum_acc / torch.clamp_min(n_steps, 1),
            diverging=diverging,
            n_steps=n_steps,
            energy=energy0,
            tree_depth=depth_pc,
        )
        return prop_q, prop_logp, prop_grad, info

    return kernel


def _hmc_transition(lg, L, q, logp, grad, eps, inv_mass, z, u_jit, u_acc, n_leapfrog, jitter):
    """One fixed-trajectory transition of every chain, given its draws: the
    standard normal z of the state's shape, the jitter and accept
    uniforms u_jit and u_acc (C,)."""
    eps_c = eps * (1.0 + jitter * (2.0 * u_jit - 1.0))
    eb = L.bexp(eps_c)
    p0 = L.momentum_from_z(z, inv_mass)

    def kin(p):
        return 0.5 * L.vdot(p, L.aim(inv_mass, p))

    energy0 = -logp + kin(p0)
    sq, sp, slp, sg = q, p0, logp, grad
    for _ in range(n_leapfrog):
        sq, sp, slp, sg = _leapfrog(lg, sq, sp, sg, eb, inv_mass, L.aim)
    delta = (-slp + kin(sp)) - energy0
    accept_prob = torch.clamp_max(torch.exp(torch.clamp_max(-delta, 0.0)), 1.0)
    accept_prob = torch.where(torch.isfinite(delta), accept_prob, 0.0)
    accept = u_acc < accept_prob
    am = L.bexp(accept)
    C = L.chains(q)
    info = NutsInfo(
        accept_prob=accept_prob,
        diverging=delta > MAX_ENERGY_DELTA,
        n_steps=torch.full((C,), n_leapfrog, dtype=torch.int32, device=q.device),
        energy=energy0,
        tree_depth=torch.zeros(C, dtype=torch.int32, device=q.device),
    )
    return torch.where(am, sq, q), torch.where(accept, slp, logp), torch.where(am, sg, grad), info


def hmc_kernel_batched(logp_batched, n_leapfrog: int = 32, jitter: float = 0.2,
                       transposed: bool = False):
    """Natively multi-chain fixed-trajectory HMC: per-chain step-size jitter
    (uniform in [1 - jitter, 1 + jitter]), momentum refresh and Metropolis
    accept, with the density and its gradient evaluated on the whole block
    a leapfrog. (generator, q, logp (C,), grad, eps, inv_mass) -> (q',
    logp', grad', NutsInfo with (C,) fields); the layouts as in
    nuts_kernel_batched. The leapfrogs run without a read to the host."""
    lg = _batched_logp_and_grad(logp_batched)
    L = _Layout(transposed)

    def kernel(generator, q, logp, grad, eps, inv_mass):
        C = L.chains(q)
        z = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
        u_jit = torch.rand(C, generator=generator, dtype=q.dtype, device=q.device)
        u_acc = torch.rand(C, generator=generator, dtype=q.dtype, device=q.device)
        return _hmc_transition(lg, L, q, logp, grad, eps, inv_mass, z, u_jit, u_acc,
                               n_leapfrog, jitter)

    return kernel
