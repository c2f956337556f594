"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Builds every kernel in `tpu_bijectors_torch/kernels/csrc/` (one nvcc per
source, all at once), then drives the bench model (8 Normal, 8 LogNormal,
Dirichlet(16), LKJ(16): linked dim 151) in float32 through the entry points
a user calls, on two paths:

1. the batched linked log-density at B = 131072:
   `Model.batched_logdensity_t_fn()` (the slab value kernel), its
   `value_and_grad_fn` (the one-pass value-and-gradient kernel) and
   `torch.autograd.grad` through `linked_logdensity_t` (the
   vector-Jacobian kernel);
2. NUTS with a likelihood on `Model(priors, loglik=hier_loglik)`, with 64
   chains, max_depth 8, 300 warmup and 200 kept transitions, target
   acceptance 0.95 (see TARGET_ACCEPT): `Model.sample` with n_samples=0
   runs the warmup, `resume_sampling` the 200 transitions from its state
   (the draws of one uninterrupted `Model.sample`, timed apart), and
   `Model.constrain` maps the draws. Every leapfrog runs the one-pass slab
   kernel for the prior and the stick-breaking and LKJ inverse-link
   kernels for the likelihood term; constraining the draws runs the two
   link kernels once more.

The launch counters are set to 0 just before each path and read just after
it; each kernel must have launched. Each kernel is held against its plain
PyTorch version on the same inputs: the slab kernels at B = 131072, the
link kernels at B = 131072 in both input layouts and at the sampler's own
shapes (64 chains, and the 200 x 64 draws), with their closed-form backward
against autograd through the plain version. The log-density is also held
against the composed per-leaf path and the plain path in float64, the
likelihood model (at 64 and 4096 states) against its float64 plain version
on the CPU, and the sampler's draws against the known Dirichlet(1 + counts)
posterior of `w` (within 5 MCSE), with R-hat <= 1.05 and divergences <= 1%.
Every kernel and its plain version is timed with CUDA events.

Prints the card's name and power limit, one JSON line per kernel, a
`sampler` line, a `{"kernels": [...]}` line, and as the last line
`{"ok": true, "device": {...}}`. Exits non-zero, with no result, when CUDA
is absent or any check fails.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 131072
SEED = 0
# float32 reordering of a 151-term sum: the kernel adds the rows one by one
# in a register, the plain version reduces them in another order. The lp
# tolerances are relative to the magnitude of the terms the sum carries
# (|sum of slab terms| + |c0 row sum|); the gradient is one row per element.
RTOL_LP = 2e-5
RTOL_G = 1e-5
RTOL_COMPOSED = 1e-4  # another algebra (cumsums, logcosh of packed slots)
# published peaks of the H100 SXM (NVIDIA data sheet), at a 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations per element of one row, per term group and kernel mode (each
# arithmetic operation, comparison, select and transcendental counts one, so
# the operation bound is a floor: an accurate expf or log1pf takes several
# instructions), plus 2 per element for the ownership select and the
# centring subtract
OPS = {
    "value": {"lin": 3, "quad": 4, "absv": 6, "sp": 8, "exp": 7, "l1p": 7},
    "value_and_grad": {"lin": 4, "quad": 7, "absv": 7, "sp": 15, "exp": 10, "l1p": 14},
    "vjp": {"lin": 2, "quad": 4, "absv": 5, "sp": 12, "exp": 6, "l1p": 9},
}
REPLACES = {
    "slab_value": "tpu_bijectors/vectorize/fused_kernel.py:226",
    "slab_value_and_grad": "tpu_bijectors/vectorize/fused_kernel.py:383",
    "slab_vjp": "tpu_bijectors/vectorize/fused_kernel.py:321",
    "simplex_inverse_logdet": "tpu_bijectors/kernels/simplex.py:181",
    "lkj_inverse": "tpu_bijectors/kernels/lkj.py:167",
}
SOURCES = {
    "simplex_inverse_logdet": "tpu_bijectors_torch/kernels/csrc/simplex_inv.cu",
    "lkj_inverse": "tpu_bijectors_torch/kernels/csrc/lkj_inv.cu",
}
# the link kernels against their plain versions, float32: x and X are
# bounded by 1 and held absolutely; the log-dets and wlog are sums of 15-120
# logs held relative to their magnitude; the backward is the closed form
# against autograd through the plain version (another order of operations)
ATOL_UNIT = 2e-6
RTOL_SUM = 1e-5
RTOL_VJP = 1e-4
# operations per element of the link kernels (each arithmetic operation,
# comparison and transcendental counts one, so this is a floor): the
# stick-breaking step per coordinate; per packed LKJ slot, and X = W'W as
# 816 multiply-adds (2 operations each) at K = 16
OPS_SIMPLEX_COORD = 22
OPS_LKJ_SLOT = 12
# the sampler run: bench.py's NUTS settings (64 chains, max_depth 8, 300
# warmup transitions) and 200 kept draws, at a target acceptance of 0.95.
# The likelihood's (ybar - mu)^2 / (sigma^2 + 1e-3) term makes a funnel in
# sigma; N(0, 1) starting positions reach log sigma ~ -3, six prior sd out,
# where at the default 0.8 the adapted step is unstable: a chain that
# warmup leaves there diverges at every transition (five of 64 chains in a
# run of this script at 0.8 on the H100). The JAX package's sampler strands
# chains there too (tests/test_torch_funnel.py, run as a script, counts
# them in either package). The smaller steps of 0.95 keep warmup from
# stranding chains there.
CHAINS, WARMUP, KEPT, MAX_DEPTH, TARGET_ACCEPT = 64, 300, 200, 8, 0.95

failures = []


def check(name, got, ref, rtol, scale=None):
    """Record got vs ref: |got - ref| <= rtol * scale elementwise (scale
    defaults to |ref| + 1e-3 max|ref|). Returns the max absolute error."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        failures.append(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        return float("inf")
    if scale is None:
        scale = ref.abs() + 1e-3 * ref.abs().max()
    err = (got - ref).abs()
    ratio = float((err / scale).max())
    max_abs = float(err.max())
    ok = bool(torch.isfinite(got).all()) and ratio <= rtol
    print(f"{name}: max_abs_err {max_abs:.3e} max_rel_err {ratio:.3e} rtol {rtol:g}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{name}: rel err {ratio:.3e} > {rtol:g}")
    return max_abs


def expect(name, cond):
    print(f"{name}: {'ok' if cond else 'FAIL'}", flush=True)
    if not cond:
        failures.append(name)


def bench_model(dists, device, dtype):
    """bench.py's model, same parameters."""
    kw = dict(device=device, dtype=dtype)
    return dists.NamedProduct.of(
        mu=dists.IIDProduct(dists.Normal(0.0, 2.0, **kw), 8),
        sigma=dists.IIDProduct(dists.LogNormal(0.0, 0.5, **kw), 8),
        w=dists.Dirichlet(np.ones(16), **kw),
        corr=dists.LKJ(16, 2.0, **kw),
    )


def hier_loglik_and_counts(dev):
    """The sampler run's likelihood (user code): the flagship likelihood of
    __graft_entry__.py at the bench widths, with a data-weighted sum over
    the correlation matrix in place of its constant trace. Its data come
    from numpy seed 1. Returns (loglik, counts): the `w` block's posterior
    is Dirichlet(1 + counts) up to the likelihood's 1e-8."""
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=dev)
    ybar = torch.as_tensor(rng.standard_normal(8), **f32)
    counts = rng.multinomial(200, np.full(16, 1 / 16))
    A = rng.standard_normal((16, 16))
    S = torch.as_tensor(0.05 * (A + A.T), **f32)
    c = torch.as_tensor(counts, **f32)

    def hier_loglik(x):
        return (
            -0.5 * torch.sum((ybar - x["mu"]) ** 2 / (x["sigma"] ** 2 + 1e-3))
            + torch.sum(c * torch.log(x["w"] + 1e-8))
            + torch.sum(S * x["corr"])
        )

    return hier_loglik, counts


def vjp(fn, y, cts):
    """d sum_i <ct_i, fn(y)_i> / dy by autograd, in y's layout."""
    v = y.detach().requires_grad_(True)
    loss = sum(torch.sum(o * c) for o, c in zip(fn(v), cts))
    return torch.autograd.grad(loss, v)[0]


def time_ms(fn, reps=25, inner=10, warmup=5, device_only=True):
    """Median over `reps` CUDA-event timings of `inner` back-to-back calls.
    With `device_only` the card spins (about 2.5 ms) while the host
    enqueues the calls, so the window holds card time only; without it the
    host's dispatch time counts too (what a caller of an entry point sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


W_ROWS = slice(16, 31)  # the Dirichlet(16) leaf's 15 linked rows
C_ROWS = slice(31, 151)  # the LKJ(16) leaf's 120 linked rows


def check_link_kernels(dev, vT, vxT, counts):
    """The simplex and LKJ kernels against their plain versions, and their
    closed-form backward against autograd through the plain versions: at
    B = 131072 in both input layouts (a contiguous (B, P) tensor and the
    swapped view of the (dim, B) state), and at the sampler path's own
    shapes (the leapfrog's swapped view of 64 chains, a partial block of
    every kernel, and `constrain`'s strided slices of the (200, 64, dim)
    draws); and finite outputs and gradients at 1e10 states. Returns the
    max absolute error of each kernel."""
    from tpu_bijectors_torch.bijectors.corr import _vec_corr_inverse_all
    from tpu_bijectors_torch.bijectors.simplex import _simplex_inverse_logdet_wlog
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import simplex as ks

    am1 = torch.as_tensor(counts, dtype=torch.float32, device=dev)  # wlog != 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {"simplex_inverse_logdet": 0.0, "lkj_inverse": 0.0}

    def rel(t):
        return t.abs() + 1e-3 * t.abs().max()

    def one(t):
        return torch.ones_like(t)

    B = vT.shape[1]
    draws = vT[:, : KEPT * CHAINS].T.contiguous().reshape(KEPT, CHAINS, -1)
    cases = {  # tag: (simplex y, LKJ y)
        f"contiguous, B = {B}": (vT[W_ROWS].T.contiguous(), vT[C_ROWS].T.contiguous()),
        f"swapped, B = {B}": (vT[W_ROWS].T, vT[C_ROWS].T),
        f"swapped, B = {CHAINS}": (vT[W_ROWS, :CHAINS].T, vT[C_ROWS, :CHAINS].T),
        f"draws' slices, B = {KEPT * CHAINS}": (
            draws[..., W_ROWS].reshape(-1, 15), draws[..., C_ROWS].reshape(-1, 120)
        ),
    }
    for lay, (y, yc) in cases.items():
        xk, ldk, wlk = ks.simplex_inverse_logdet(y, am1)
        xp, ldp, wlp = ks.simplex_inverse_logdet_plain(y, am1)
        e = err["simplex_inverse_logdet"]
        e = max(e, check(f"simplex x vs plain ({lay})", xk, xp, ATOL_UNIT, one(xp)))
        e = max(e, check(f"simplex ld vs plain ({lay})", ldk, ldp, RTOL_SUM, rel(ldp)))
        e = max(e, check(f"simplex wlog vs plain ({lay})", wlk, wlp, RTOL_SUM, rel(wlp)))
        xn, ldn, _ = ks.simplex_inverse_logdet(y, None, want_x=False)
        expect(f"simplex without x or wlog gives the same ld ({lay})",
               xn is None and torch.equal(ldn, ldk))
        err["simplex_inverse_logdet"] = e

        Xk, ljk, dwk, Wk = kl.lkj_inverse(yc, 16, want_w=True)
        Xp, ljp, dwp, Wp = kl.lkj_inverse_plain(yc, 16, want_w=True)
        e = err["lkj_inverse"]
        e = max(e, check(f"lkj X vs plain ({lay})", Xk, Xp, ATOL_UNIT, one(Xp)))
        e = max(e, check(f"lkj W vs plain ({lay})", Wk, Wp, ATOL_UNIT, one(Wp)))
        e = max(e, check(f"lkj logJ vs plain ({lay})", ljk, ljp, RTOL_SUM, rel(ljp)))
        e = max(e, check(f"lkj log diag W vs plain ({lay})", dwk, dwp, RTOL_SUM, rel(dwp)))
        Xn, ljn, _, Wn = kl.lkj_inverse(yc, 16)
        expect(f"lkj without W gives the same X and logJ ({lay})",
               Wn is None and torch.equal(Xn, Xk) and torch.equal(ljn, ljk))
        err["lkj_inverse"] = e

        # backward: the closed form (kernel forward) against autograd
        # through the plain version, on the same card and inputs
        n = y.shape[0]
        cts = (torch.randn((n, 16), generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev))
        g_k = vjp(lambda v: _simplex_inverse_logdet_wlog(v, am1), y, cts)
        g_p = vjp(lambda v: ks.simplex_inverse_logdet_plain(v, am1), y, cts)
        check(f"simplex backward vs autograd of plain ({lay})", g_k, g_p, RTOL_VJP)
        cts = (torch.randn((n, 16, 16), generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev),
               torch.randn((n, 16), generator=gen, device=dev))
        g_k = vjp(_vec_corr_inverse_all, yc, cts)
        g_p = vjp(lambda v: kl.lkj_inverse_plain(v, 16)[:3], yc, cts)
        check(f"lkj backward vs autograd of plain ({lay})", g_k, g_p, RTOL_VJP)
        del xk, xp, Xk, Xp, Wk, Wp, g_k, g_p, cts
    del draws

    # 1e10 states: finite outputs that agree with the plain versions, and
    # a finite backward
    y, yc = vxT[W_ROWS].T, vxT[C_ROWS].T
    outs = ks.simplex_inverse_logdet(y, am1)
    expect("simplex outputs finite at 1e10", all(bool(torch.isfinite(t).all()) for t in outs))
    for got, ref, nm in zip(outs, ks.simplex_inverse_logdet_plain(y, am1), ("x", "ld", "wlog")):
        check(f"1e10: simplex {nm} vs plain", got, ref, RTOL_SUM, rel(ref) + 1e-6)
    outs = kl.lkj_inverse(yc, 16, want_w=True)
    expect("lkj outputs finite at 1e10", all(bool(torch.isfinite(t).all()) for t in outs))
    for got, ref, nm in zip(outs, kl.lkj_inverse_plain(yc, 16, True), ("X", "logJ", "ldw", "W")):
        check(f"1e10: lkj {nm} vs plain", got, ref, RTOL_SUM, rel(ref) + 1e-6)
    B = y.shape[0]
    g = vjp(lambda v: _simplex_inverse_logdet_wlog(v, am1), y,
            (torch.ones((B, 16), device=dev), torch.ones(B, device=dev),
             torch.ones(B, device=dev)))
    expect("simplex backward finite at 1e10", bool(torch.isfinite(g).all()))
    g = vjp(_vec_corr_inverse_all, yc,
            (torch.ones((B, 16, 16), device=dev), torch.ones(B, device=dev),
             torch.ones((B, 16), device=dev)))
    expect("lkj backward finite at 1e10", bool(torch.isfinite(g).all()))
    return err


def check_link_entry_points(dev, vT, loglik, counts):
    """from_linked_vec, Model.constrain, Dirichlet.fused_linked_logdensity
    and the likelihood term of value_and_grad_fn each launch the link
    kernels on a CUDA state; the likelihood model's value and gradient agree
    with its float64 plain version on the CPU."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.bijectors import SimplexBijector

    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    u, dim = model.unconstrainer(), model.dim()
    v64 = vT[:, :64].T.contiguous()  # 64 batch-major states
    f = model.batched_logdensity_t_fn()

    def launched(what, fn, names):
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        got = {k: kernels.LAUNCHES[k] for k in names}
        expect(f"{what} launches {names}: {got}", all(n > 0 for n in got.values()))

    links = ("simplex_inverse_logdet", "lkj_inverse")
    launched("from_linked_vec", lambda: u.from_linked_vec(v64), links)
    launched("Model.constrain of (4, 16, dim) draws",
             lambda: model.constrain(v64.reshape(4, 16, dim)), links)
    w = dists.Dirichlet(np.ones(16), device=dev, dtype=torch.float32)
    launched("Dirichlet.fused_linked_logdensity",
             lambda: w.fused_linked_logdensity(SimplexBijector(), v64[:, W_ROWS], False),
             links[:1])
    launched("value_and_grad_fn with the likelihood",
             lambda: f.value_and_grad_fn(v64.T.contiguous()),
             ("slab_value_and_grad",) + links)

    # the likelihood model in float32 on the card against float64 on the
    # CPU, at the leapfrog's batch of 64 chains and at 4096
    ll_cpu, _ = hier_loglik_and_counts("cpu")  # the same float32 data
    cpu = tbt.Model(bench_model(dists, "cpu", torch.float64), loglik=ll_cpu, device="cpu")
    for n in (CHAINS, 4096):
        vs = vT[:, :n].contiguous()
        lp, g = f.value_and_grad_fn(vs)
        lp64, g64 = cpu.batched_logdensity_t_fn().value_and_grad_fn(vs.double().cpu())
        check(f"likelihood model lp vs float64 CPU, B = {n}", lp.cpu(), lp64, 2e-5,
              lp64.abs() + 1e-3 * lp64.abs().max())
        # a gradient entry is a float32 sum of terms as large as the largest
        # entry (counts / w through the stick-breaking Jacobian), so its
        # error scales with max |g|
        check(f"likelihood model g vs float64 CPU, B = {n}", g.cpu(), g64, 1e-4,
              g64.abs() + 1e-2 * g64.abs().max())


def run_sampler(dev, loglik, counts):
    """The second main path: NUTS on the bench model with the likelihood,
    driven through public entry points in two calls so that warmup and
    sampling are timed apart (each between torch.cuda.synchronize()
    calls): `Model.sample` with n_samples=0 runs the warmup, and
    `resume_sampling` continues from its state (the draws an uninterrupted
    `Model.sample` would give); `Model.constrain` maps the linked draws.
    The launch counters are zeroed just before the first call and read
    after the last."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, resume_sampling

    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    _, state, _ = model.sample(
        gen, n_chains=CHAINS, n_warmup=WARMUP, n_samples=0, max_depth=MAX_DEPTH,
        target_accept=TARGET_ACCEPT, constrained=False,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, s1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    raw, state, stats = resume_sampling(
        model.batched_logdensity_t_fn(), state, KEPT, kernel="nuts_batched_t",
        max_depth=MAX_DEPTH,
    )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2, s2 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    samples = model.constrain(raw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the sampler path: {launches}", flush=True)
    for k in ("slab_value_and_grad",) + tuple(SOURCES):
        expect(f"{k} launched on the sampler path", launches[k] > 0)

    during = {k: l2[k] - l1[k] for k in l2}
    leapfrogs = during["slab_value_and_grad"]  # one per batched leapfrog
    sampling_s = t2 - t1
    expect("raw draws (200, 64, 151) and finite",
           tuple(raw.shape) == (KEPT, CHAINS, 151) and bool(torch.isfinite(raw).all()))
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    w = samples["w"]
    post = (1.0 + counts) / (16.0 + counts.sum())
    mcse = diagnostics.mcse_mean(w)
    dev_w = np.abs(w.double().mean(dim=(0, 1)).cpu().numpy() - post) / mcse
    n_div = int(stats.diverging.sum())
    line = {
        "chains": CHAINS, "warmup": WARMUP, "kept": KEPT, "max_depth": MAX_DEPTH,
        "target_accept": TARGET_ACCEPT,
        "warmup_s": t1 - t0,
        "sampling_s": sampling_s,
        "constrain_s": t3 - t2,
        "draws_per_s": CHAINS * KEPT / sampling_s,
        "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": (s2 - s1) / max(leapfrogs, 1),
        "step_size": float(state.eps),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "chains_with_divergences": int((stats.diverging.sum(0) > 0).sum()),
        "smallest_sigma_of_a_diverging_chain": (
            float(samples["sigma"][:, stats.diverging.any(0)].min()) if n_div else None
        ),
        "transitions": CHAINS * KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "min_ess_bulk": float(np.min(ess)),
        "max_w_dev_in_mcse": float(np.max(dev_w)),
    }
    expect(f"max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"divergences {n_div} <= 1% of {CHAINS * KEPT}", n_div <= 0.01 * CHAINS * KEPT)
    expect(f"w means within 5 MCSE of Dirichlet(1 + counts) (max {np.max(dev_w):.2f})",
           bool(np.all(dev_w <= 5.0)))
    expect("constrained draws finite",
           all(bool(torch.isfinite(t).all()) for t in samples.values()))
    return line, launches


def time_link_kernels(vT, launches, err):
    """The link kernels' rows at B = 131072 on the swapped view of the state
    (the layout the leapfrog reads), kernel and plain version timed alike."""
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import simplex as ks

    B = vT.shape[1]
    y, yc = vT[W_ROWS].T, vT[C_ROWS].T
    runs = {
        "simplex_inverse_logdet": (
            lambda: ks.simplex_inverse_logdet(y),
            lambda: ks.simplex_inverse_logdet_plain(y),
            B * 4 * (15 + 16 + 1),
            B * 15 * OPS_SIMPLEX_COORD,
        ),
        "lkj_inverse": (
            lambda: kl.lkj_inverse(yc, 16),
            lambda: kl.lkj_inverse_plain(yc, 16),
            B * 4 * (120 + 256 + 1 + 16),
            B * (120 * OPS_LKJ_SLOT + 2 * 816),
        ),
    }
    rows = []
    for k, (kern, plain, nbytes, ops) in runs.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        row = {
            "name": k,
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": launches[k],
            "max_abs_err": err[k],
            "ms": time_ms(kern),
            "plain_ms": time_ms(plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        print(json.dumps({"bound_inputs": {"name": k, "bytes": nbytes, "ops": ops}}), flush=True)
    # the variants the paths also run: contiguous input, and W written for
    # the backward (the leapfrog's case)
    y_c, yc_c = y.contiguous(), yc.contiguous()
    extra = {
        "simplex_contiguous_ms": time_ms(lambda: ks.simplex_inverse_logdet(y_c)),
        "lkj_with_W_ms": time_ms(lambda: kl.lkj_inverse(yc, 16, want_w=True)),
        "lkj_contiguous_ms": time_ms(lambda: kl.lkj_inverse(yc_c, 16)),
    }
    print(json.dumps({"link_variants": extra}), flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.kernels import build
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    so = build.build()
    build.load()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    model = tbt.Model(bench_model(dists, dev, torch.float32), device=dev)
    u = model.unconstrainer()
    dim = model.dim()
    expect(f"dim {dim} == 151", dim == 151)
    rng = np.random.default_rng(SEED)
    v = 0.5 * rng.standard_normal((BATCH, dim))
    vT = torch.as_tensor(np.ascontiguousarray(v.T), dtype=torch.float32, device=dev)
    f = model.batched_logdensity_t_fn()

    # --- the main path: value, value-and-gradient, autograd ------------------
    kernels.reset_launch_counts()
    for _ in range(3):
        lp = f(vT)
    for _ in range(3):
        lp_vg, g_vg = f.value_and_grad_fn(vT)
    vr = vT.detach().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(u.linked_logdensity_t(vr).sum(), vr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the main path: {launches}", flush=True)
    for k in ("slab_value", "slab_value_and_grad", "slab_vjp"):
        expect(f"{k} launched on the main path", launches[k] > 0)
    expect("lp shape (B,)", lp.shape == (BATCH,) and lp_vg.shape == (BATCH,))
    expect("g shape (dim, B)", g_vg.shape == (dim, BATCH) and g_ag.shape == (dim, BATCH))

    # --- value ---------------------------------------------------------------
    cf, c0sum = fk._prep(u, vT)
    val_plain = fb.slab_value_plain(vT, cf)
    scale = val_plain.abs() + c0sum.abs()
    err = {}
    err["slab_value"] = check(
        "value kernel vs plain", fk.slab_value(vT, cf), val_plain, RTOL_LP, scale
    )
    check("linked_logdensity_t vs plain fused", lp, val_plain + c0sum, RTOL_LP, scale)
    composed = u._linked_logdensity_t_children(vT)
    check("linked_logdensity_t vs composed", lp, composed, RTOL_COMPOSED, scale)
    model64 = tbt.Model(bench_model(dists, dev, torch.float64), device=dev)
    vT64 = vT.double()
    cf64, c0sum64 = fk._prep(model64.unconstrainer(), vT64)
    lp64 = fb.slab_value_plain(vT64, cf64) + c0sum64
    check("linked_logdensity_t vs plain float64", lp, lp64, RTOL_LP, scale)
    del composed, vT64, lp64

    # --- value and gradient --------------------------------------------------
    lp_p, g_p = fb.slab_value_and_grad_plain(vT, cf)
    lp_k, g_k = fk.slab_value_and_grad(vT, cf)
    err["slab_value_and_grad"] = max(
        check("value-and-grad kernel lp vs plain", lp_k, lp_p, RTOL_LP, scale),
        check("value-and-grad kernel g vs plain", g_k, g_p, RTOL_G),
    )
    check("value_and_grad_fn lp vs plain", lp_vg, lp_p + c0sum, RTOL_LP, scale)
    check("value_and_grad_fn g vs plain", g_vg, g_p, RTOL_G)

    # --- autograd ------------------------------------------------------------
    ones = torch.ones(BATCH, device=dev)
    g_vjp_plain = fb.slab_vjp_plain(vT, cf, ones)
    err["slab_vjp"] = check(
        "vjp kernel vs plain", fk.slab_vjp(vT, cf, ones), g_vjp_plain, RTOL_G
    )
    check("autograd g vs value_and_grad_fn g", g_ag, g_vg, RTOL_G)
    check("autograd g vs plain partials", g_ag, g_p, RTOL_G)
    del lp_p, g_p, lp_k, g_k, g_vjp_plain, g_ag, g_vg

    # --- extreme states ------------------------------------------------------
    vx = 1e10 * rng.standard_normal((4096, dim))
    vx[::7] = np.sign(vx[::7]) * 1e10
    vxT = torch.as_tensor(np.ascontiguousarray(vx.T), dtype=torch.float32, device=dev)
    lpx = f(vxT)
    lpx_vg, gx = f.value_and_grad_fn(vxT)
    expect("lp finite at 1e10 states", bool(torch.isfinite(lpx).all()))
    expect("value_and_grad lp finite at 1e10", bool(torch.isfinite(lpx_vg).all()))
    expect("g finite at 1e10 states", bool(torch.isfinite(gx).all()))
    cfx, c0x = fk._prep(u, vxT)
    lpx_p, gx_p = fb.slab_value_and_grad_plain(vxT, cfx)
    check("1e10: lp vs plain", lpx, lpx_p + c0x, RTOL_LP, lpx_p.abs() + c0x.abs())
    check("1e10: Dirichlet and LKJ rows of g vs plain", gx[16:], gx_p[16:], RTOL_G)
    check("1e10: Normal and LogNormal rows of g vs plain", gx[:16], gx_p[:16], RTOL_G)

    # --- the inverse-link kernels, their entry points, the likelihood --------
    loglik, counts = hier_loglik_and_counts(dev)
    err.update(check_link_kernels(dev, vT, vxT, counts))
    check_link_entry_points(dev, vT, loglik, counts)

    # --- the second main path: NUTS with the likelihood ----------------------
    sampler_line, sampler_launches = run_sampler(dev, loglik, counts)
    launches.update({k: sampler_launches[k] for k in SOURCES})

    # --- timing ----------------------------------------------------------------
    groups_per_row = [fb._groups_and_used(cf[r : r + 1])[0] for r in range(dim)]
    nbytes = {
        "slab_value": vT.numel() * 4 + BATCH * 4 + cf.numel() * 4,
        "slab_value_and_grad": 2 * vT.numel() * 4 + BATCH * 4 + cf.numel() * 4,
        "slab_vjp": 2 * vT.numel() * 4 + BATCH * 4 + cf.numel() * 4,
    }
    mode = {"slab_value": "value", "slab_value_and_grad": "value_and_grad", "slab_vjp": "vjp"}
    runs = {
        "slab_value": (lambda: fk.slab_value(vT, cf), lambda: fb.slab_value_plain(vT, cf)),
        "slab_value_and_grad": (
            lambda: fk.slab_value_and_grad(vT, cf),
            lambda: fb.slab_value_and_grad_plain(vT, cf),
        ),
        "slab_vjp": (
            lambda: fk.slab_vjp(vT, cf, ones),
            lambda: fb.slab_vjp_plain(vT, cf, ones),
        ),
    }
    rows = []
    for k, (kern, plain) in runs.items():
        ops = BATCH * sum(2 + sum(OPS[mode[k]][g] for g in gs) for gs in groups_per_row)
        t_bytes = nbytes[k] / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        row = {
            "name": k,
            "route": "cuda",
            "source": "tpu_bijectors_torch/kernels/csrc/fused_slab.cu",
            "replaces": REPLACES[k],
            "launches": launches[k],
            "max_abs_err": err[k],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        # the counts bound_ms is computed from (not measured)
        print(json.dumps({"bound_inputs": {"name": k, "bytes": nbytes[k], "ops": ops}}),
              flush=True)

    rows += time_link_kernels(vT, launches, err)

    # the entry points as a caller sees them: host dispatch included, at the
    # full batch and at a sampler's batch of 64 chains
    v64 = vT[:, :64].contiguous()
    e2e = {
        "value_ms_B131072": time_ms(lambda: f(vT), device_only=False),
        "value_and_grad_ms_B131072": time_ms(
            lambda: f.value_and_grad_fn(vT), device_only=False
        ),
        "value_ms_B64": time_ms(lambda: f(v64), device_only=False),
        "value_and_grad_ms_B64": time_ms(
            lambda: f.value_and_grad_fn(v64), device_only=False
        ),
    }
    print(json.dumps({"end_to_end": e2e}), flush=True)
    print(json.dumps({"sampler": sampler_line}), flush=True)

    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
