"""The port's NUTS sampler and its likelihood model against the JAX
package, float64 on the CPU.

Adaptation (schedule, dual averaging, Welford), the tree counter's bit
trick and the diagnostics on the same numpy inputs (1e-12); the leapfrog
step of both layouts (transposed, `nuts_batched_t`; batch-major,
`nuts_batched`) against the same formula evaluated with the JAX package's
value-and-gradient; the sampler's `inv_mass0` and `thin`, and the whole
warmup-and-sample loop of `nuts_batched`, against the JAX package's on a
deterministic stand-in transition, and `resume_sampling`'s continuation
in both layouts; `Model(loglik=...)`'s transposed log-density and its
value-and-gradient against the JAX package's on a scaled-down bench model
with a likelihood (1e-10); `kernel='auto'`'s choice against the JAX
package's; and whole seeded `Model.sample` runs of both layouts held to
the known Dirichlet(1 + counts) posterior of its `w` block. The random
streams differ (torch generators, JAX keys), so whole runs are compared in
distribution, not draw by draw.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CPU64, spec_of

from tpu_bijectors import diagnostics as jdiag
from tpu_bijectors import dists as jd
from tpu_bijectors.infer import Model as JModel
from tpu_bijectors.infer import adapt as jadapt
from tpu_bijectors.infer import sampler as jsampler
from tpu_bijectors.infer import hmc_batched as jhmc_batched
from tpu_bijectors.infer.hmc import NutsInfo as JNutsInfo
from tpu_bijectors.infer.hmc import _trailing_zeros as j_trailing_zeros
from tpu_bijectors.infer.hmc import apply_inv_mass as j_apply_inv_mass

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import diagnostics, kernels
from tpu_bijectors_torch.infer import adapt, hmc_batched, sampler
from tpu_bijectors_torch.infer.hmc import (
    NutsInfo,
    _trailing_zeros,
    apply_inv_mass,
    sample_momentum,
)

TOL = dict(rtol=1e-12, atol=1e-12)
MODEL_TOL = dict(rtol=1e-10, atol=1e-10)

# ---------------------------------------------------------------------------
# the scaled-down likelihood model: the bench model's families at small
# widths, and the bench likelihood's form (chip_smoke.py) at those widths
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(1)
YBAR = _rng.standard_normal(2)
COUNTS = _rng.multinomial(200, np.full(4, 1 / 4)).astype(np.float64)
_A = _rng.standard_normal((3, 3))
S = 0.05 * (_A + _A.T)


def _jax_priors():
    return jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.0, 2.0), 2),
        sigma=jd.IIDProduct(jd.LogNormal(0.0, 0.5), 2),
        w=jd.Dirichlet(jnp.ones(4)),
        corr=jd.LKJ(3, 2.0),
    )


def _jax_loglik(x):
    return (
        -0.5 * jnp.sum((YBAR - x["mu"]) ** 2 / (x["sigma"] ** 2 + 1e-3))
        + jnp.sum(COUNTS * jnp.log(x["w"] + 1e-8))
        + jnp.sum(S * x["corr"])
    )


_T = {k: torch.as_tensor(v) for k, v in (("ybar", YBAR), ("counts", COUNTS), ("S", S))}


def _torch_loglik(x):
    return (
        -0.5 * torch.sum((_T["ybar"] - x["mu"]) ** 2 / (x["sigma"] ** 2 + 1e-3))
        + torch.sum(_T["counts"] * torch.log(x["w"] + 1e-8))
        + torch.sum(_T["S"] * x["corr"])
    )


def _models():
    priors = _jax_priors()
    port = tbt.Model(tbt.dist_from_spec(spec_of(priors), **CPU64), loglik=_torch_loglik,
                     device="cpu")
    return JModel(priors=priors, loglik=_jax_loglik), port


# ---------------------------------------------------------------------------
# adaptation, tree counter, diagnostics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_warmup", [0, 10, 100, 149, 150, 300, 1000])
def test_build_schedule_matches_jax(n_warmup):
    wid, wend = adapt.build_schedule(n_warmup)
    jwid, jwend = jadapt.build_schedule(n_warmup)
    np.testing.assert_array_equal(wid, np.asarray(jwid))
    np.testing.assert_array_equal(wend, np.asarray(jwend))


def test_stepsize_update_matches_jax(rng):
    s = adapt.stepsize_init(0.3, torch.float64)
    js = jadapt.stepsize_init(0.3, jnp.float64)
    for a in rng.uniform(0.0, 1.0, 40):
        s = adapt.stepsize_update(s, torch.tensor(a, dtype=torch.float64), target=0.75)
        js = jadapt.stepsize_update(js, jnp.asarray(a), target=0.75)
    for got, ref in zip(s, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_welford_matches_jax(rng):
    s, js = adapt.welford_init(5), jadapt.welford_init(5)
    for _ in range(6):
        xs = rng.standard_normal((8, 5)) * np.arange(1, 6) + 3.0
        s = adapt.welford_update_batch(s, torch.as_tensor(xs))
        js = jadapt.welford_update_batch(js, jnp.asarray(xs))
    for got, ref in zip(s, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for reg in (True, False):
        np.testing.assert_allclose(
            adapt.welford_variance(s, reg).numpy(),
            np.asarray(jadapt.welford_variance(js, reg)), **TOL,
        )


def test_trailing_zeros_matches_jax():
    n = np.arange(1, 1025, dtype=np.int32)
    ref = np.asarray(j_trailing_zeros(jnp.asarray(n)))
    np.testing.assert_array_equal([_trailing_zeros(int(k)) for k in n], ref)


def test_inverse_mass_and_momentum(rng):
    """The diagonal M^-1 p against the JAX package's, batch-major and, with
    (dim, 1) weights, on the transposed state; the momentum is the
    generator's standard normal draw scaled by sqrt(M)."""
    inv_mass, p = rng.uniform(0.5, 2.0, 5), rng.standard_normal((7, 5))
    ref = np.asarray(j_apply_inv_mass(jnp.asarray(inv_mass), jnp.asarray(p)))
    im = torch.as_tensor(inv_mass)
    np.testing.assert_allclose(apply_inv_mass(im, torch.as_tensor(p)).numpy(), ref, **TOL)
    np.testing.assert_allclose(
        apply_inv_mass(im[:, None], torch.as_tensor(p.T)).numpy(), ref.T, **TOL
    )
    q = torch.zeros(5, 4096, dtype=torch.float64)
    mom = sample_momentum(torch.Generator().manual_seed(3), q, im[:, None])
    z = torch.randn(q.shape, generator=torch.Generator().manual_seed(3), dtype=q.dtype)
    np.testing.assert_allclose((mom * torch.sqrt(im)[:, None]).numpy(), z.numpy(), rtol=1e-15)


def test_diagnostics_match_jax(rng):
    # AR(1) chains with one shifted chain, and a tied indicator column
    draws = np.zeros((200, 4, 3))
    for t in range(1, 200):
        draws[t] = 0.6 * draws[t - 1] + rng.standard_normal((4, 3))
    draws[:, 0] += 0.3
    draws[:, :, 2] = (draws[:, :, 2] > 0.5).astype(np.float64)
    np.testing.assert_allclose(
        diagnostics.split_rhat(draws), np.asarray(jdiag.split_rhat(jnp.asarray(draws))), **TOL
    )
    for name in ("ess_bulk", "rhat", "mcse_mean"):
        np.testing.assert_allclose(
            getattr(diagnostics, name)(torch.as_tensor(draws)),
            getattr(jdiag, name)(draws), **TOL,
        )


# ---------------------------------------------------------------------------
# the likelihood model and the leapfrog
# ---------------------------------------------------------------------------


def _state(rng, dim, C=6, scale=0.7):
    return scale * rng.standard_normal((dim, C))


def test_model_with_loglik_matches_jax(rng):
    jm, tm = _models()
    vT = _state(rng, tm.dim())
    f, jf = tm.batched_logdensity_t_fn(), jm.batched_logdensity_t_fn()
    np.testing.assert_allclose(
        f(torch.as_tensor(vT)).numpy(), np.asarray(jax.jit(jf)(jnp.asarray(vT))), **MODEL_TOL
    )
    lp, g = f.value_and_grad_fn(torch.as_tensor(vT))
    jlp, jg = jax.jit(jf.value_and_grad_fn)(jnp.asarray(vT))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **MODEL_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **MODEL_TOL)
    # the gradient is autograd's through the density, and the likelihood
    # is evaluated on the constrained sample
    v = torch.as_tensor(vT).requires_grad_(True)
    (g_ag,) = torch.autograd.grad(f(v).sum(), v)
    np.testing.assert_allclose(g.numpy(), g_ag.numpy(), **MODEL_TOL)
    x = tm.constrain(torch.as_tensor(vT.T))
    np.testing.assert_allclose(
        (f(torch.as_tensor(vT)) - tm.unconstrainer().linked_logdensity_t(torch.as_tensor(vT)))
        .numpy(),
        torch.func.vmap(_torch_loglik)(x).numpy(), **MODEL_TOL,
    )


@pytest.mark.parametrize("transposed", [True, False])
def test_leapfrog_matches_formula_with_jax_gradient(rng, transposed):
    """One step of each layout: the transposed one on (dim, C) states with
    Model.batched_logdensity_t_fn, the batch-major one on (C, dim) states
    with Model.batched_logdensity_fn (the JAX package's value and gradient
    through jax.vjp, as its batch-major leapfrog takes them)."""
    jm, tm = _models()
    dim, C = tm.dim(), 6
    q, p = _state(rng, dim, C), rng.standard_normal((dim, C))
    eps_dir = 0.2 * np.where(rng.uniform(size=C) < 0.5, 1.0, -1.0)[None, :]
    inv_mass = rng.uniform(0.5, 1.5, dim)[:, None]
    if transposed:
        jvg = jax.jit(jm.batched_logdensity_t_fn().value_and_grad_fn)
        vg = tm.batched_logdensity_t_fn().value_and_grad_fn
    else:
        q, p, eps_dir, inv_mass = q.T, p.T, eps_dir.T, inv_mass.T
        jvg = jax.jit(jhmc_batched._batched_logp_and_grad(jm.batched_logdensity_fn()))
        vg = tm.batched_logdensity_fn().value_and_grad_fn
    _, g0 = jvg(jnp.asarray(q))
    p_half = p + 0.5 * eps_dir * np.asarray(g0)
    q1 = q + eps_dir * inv_mass * p_half
    lp1, g1 = jvg(jnp.asarray(q1))
    p1 = p_half + 0.5 * eps_dir * np.asarray(g1)

    tq = torch.as_tensor(np.ascontiguousarray(q))
    got = hmc_batched._leapfrog(
        vg, tq, torch.as_tensor(p), vg(tq)[1], torch.as_tensor(eps_dir),
        torch.as_tensor(inv_mass),
    )
    for a, b in zip(got, (q1, p1, lp1, g1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)


# ---------------------------------------------------------------------------
# the sampler's options: inv_mass0 and thin
# ---------------------------------------------------------------------------


class _Info(NamedTuple):
    accept_prob: object
    diverging: object
    n_steps: object
    tree_depth: object


def _fake_transition(q, to_int):
    """A deterministic stand-in for the NUTS transition, the same in both
    packages: every coordinate moves by 1, and the stats are functions of
    the chain's first coordinate."""
    c = q[:, 0]
    return q + 1.0, _Info((0.37 * c) % 1.0, (c % 3) == 0, to_int(c % 5 + 1), to_int(c % 4))


def _vkernel(gen, q, lp, g, eps, im):
    q1, info = _fake_transition(q, lambda t: t.to(torch.int32))
    return q1, lp, g, info


def _jvkernel(keys, q, lp, g, eps, im):
    q1, info = _fake_transition(q, lambda t: t.astype(jnp.int32))
    return q1, lp, g, info


def _init_both(q0, inv_mass0):
    state = sampler.init_sampler(
        lambda q: -0.5 * torch.sum(q * q, dim=-1), torch.Generator().manual_seed(0),
        torch.as_tensor(q0), batched=True, inv_mass0=inv_mass0,
    )
    jstate = jsampler.init_sampler(
        lambda q: -0.5 * jnp.sum(q * q, axis=-1), jax.random.PRNGKey(0), jnp.asarray(q0),
        batched=True, inv_mass0=inv_mass0,
    )
    return state, jstate


@pytest.mark.parametrize("thin", [1, 3])
def test_run_sampling_thin_and_inv_mass0_match_jax(thin):
    """inv_mass0 seeds the state's inverse mass in place of the identity,
    and `thin` keeps every thin-th state and aggregates the block's stats
    (mean accept, any divergence, summed steps, max depth) as the JAX
    package does: 7 transitions at thin 3 give 2 kept states."""
    q0 = np.arange(12.0).reshape(4, 3)
    inv_mass0 = np.array([0.5, 2.0, 1.5])
    state, jstate = _init_both(q0, inv_mass0)
    np.testing.assert_array_equal(state.inv_mass.numpy(), inv_mass0)
    for f in ("inv_mass", "logp", "grad"):
        np.testing.assert_allclose(
            getattr(state, f).numpy(), np.asarray(getattr(jstate, f)), **TOL
        )
    samples, state, stats = sampler._run_sampling(_vkernel, state, 7, thin)
    jsamples, jstate, jstats = jsampler._run_sampling(_jvkernel, jstate, 7, thin)
    assert samples.shape == (7 // thin, 4, 3) and state.iteration == int(jstate.iteration)
    np.testing.assert_allclose(samples.numpy(), np.asarray(jsamples), **TOL)
    for f in sampler.RunStats._fields:
        got, ref = getattr(stats, f).numpy(), np.asarray(getattr(jstats, f))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64), **TOL)


def _stand_in_kernel(info_cls):
    """A deterministic stand-in for the batch-major NUTS transition, the
    same in both packages: the state contracts towards the step size, and
    the stats are functions of the chain's first coordinate and the step
    size, so the step-size and mass adaptation feed back into the run."""

    def step_kernel(key, q, lp, g, eps, im):
        c = q[:, 0]
        acc = 1.0 / (1.0 + eps * (1.0 + c * c))
        info = info_cls(acc, c > 2.5, 0 * c + 3, -lp, 0 * c + 2)
        return 0.7 * q + eps * im + 0.1 * (c / (1.0 + c * c))[:, None], lp - 1.0, g, info

    return step_kernel


@pytest.mark.parametrize("thin", [1, 3])
def test_nuts_batched_warmup_and_sample_drive_match_jax(monkeypatch, thin):
    """warmup_and_sample(kernel='nuts_batched') against the JAX package's,
    both driving the same deterministic stand-in transition in place of
    the batch-major NUTS kernel: the dual-averaged step size, the Welford
    mass windows, the metric refresh and the restarted step-size
    adaptation, `inv_mass0` and `thin` give the same draws, state and
    stats (1e-12)."""
    monkeypatch.setattr(
        sampler, "nuts_kernel_batched",
        lambda fn, max_depth=10: _stand_in_kernel(NutsInfo),
    )
    monkeypatch.setattr(
        jhmc_batched, "nuts_kernel_batched",
        lambda fn, max_depth=10: _stand_in_kernel(JNutsInfo),
    )
    q0 = np.linspace(-1.0, 2.0, 12).reshape(4, 3)
    inv_mass0 = np.array([0.5, 2.0, 1.5])
    kw = dict(n_warmup=160, n_samples=7, thin=thin, eps0=0.3, inv_mass0=inv_mass0,
              kernel="nuts_batched")
    got = sampler.warmup_and_sample(
        lambda q: -0.5 * torch.sum(q * q, dim=-1), torch.Generator().manual_seed(0),
        torch.as_tensor(q0), **kw,
    )
    ref = jsampler.warmup_and_sample(
        lambda q: -0.5 * jnp.sum(q * q, axis=-1), jax.random.PRNGKey(0), jnp.asarray(q0), **kw,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    for f in ("q", "logp", "eps", "inv_mass"):
        np.testing.assert_allclose(
            getattr(got[1], f).numpy(), np.asarray(getattr(ref[1], f)), **TOL
        )
    for a, b in zip(got[1].ss + got[1].welford, ref[1].ss + ref[1].welford):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **TOL)
    for f in sampler.RunStats._fields:
        np.testing.assert_allclose(
            getattr(got[2], f).numpy().astype(np.float64),
            np.asarray(getattr(ref[2], f)).astype(np.float64), **TOL,
        )


@pytest.mark.parametrize("kernel", ["nuts_batched_t", "nuts_batched"])
def test_resume_sampling_repeats_the_tail_of_an_uninterrupted_run(kernel):
    """warmup_and_sample with n_samples=0 returns the post-warmup state (and
    empty draws and stats); resume_sampling from it gives the draws and
    stats of one uninterrupted run, bit for bit, as in the JAX package, in
    either layout."""
    scale = torch.tensor([0.5, 1.0, 3.0], dtype=torch.float64)

    def ld(v):
        if kernel == "nuts_batched_t":
            return -0.5 * torch.sum((v / scale[:, None]) ** 2, dim=0)
        return -0.5 * torch.sum((v / scale) ** 2, dim=-1)

    q0 = torch.randn((4, 3), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    kw = dict(n_warmup=30, kernel=kernel, max_depth=4)
    full = sampler.warmup_and_sample(ld, torch.Generator().manual_seed(1), q0, n_samples=6, **kw)
    empty, state, stats = sampler.warmup_and_sample(
        ld, torch.Generator().manual_seed(1), q0, n_samples=0, **kw
    )
    assert empty.shape == (0, 4, 3) and all(f.shape == (0, 4) for f in stats)
    assert [f.dtype for f in stats] == [f.dtype for f in full[2]]
    part = sampler.resume_sampling(ld, state, 6, kernel=kernel, max_depth=4)
    assert torch.equal(part[0], full[0]) and torch.equal(part[1].q, full[1].q)
    for a, b in zip(part[2], full[2]):
        assert torch.equal(a, b)


def test_inv_mass0_of_the_wrong_shape_raises_as_in_jax():
    q0 = np.zeros((2, 3))
    with pytest.raises(ValueError, match="inv_mass0 shape"):
        sampler.init_sampler(lambda q: -torch.sum(q * q, -1), torch.Generator(),
                             torch.as_tensor(q0), batched=True, inv_mass0=np.ones(4))
    with pytest.raises(ValueError, match="inv_mass0 shape"):
        jsampler.init_sampler(lambda q: -jnp.sum(q * q, -1), jax.random.PRNGKey(0),
                              jnp.asarray(q0), batched=True, inv_mass0=np.ones(4))


# ---------------------------------------------------------------------------
# a whole run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernels_on", [True, False])
def test_model_sample_recovers_dirichlet_posterior(kernels_on):
    """8 chains, 150 warmup + 150 draws, max_depth 6, seeded, through
    kernel='auto': with the kernels on, the transposed `nuts_batched_t`;
    with them off, the batch-major `nuts_batched` (where the JAX package
    takes it too). Rank-normalized R-hat <= 1.1 on every linked coordinate,
    and each posterior mean of w within 5 MCSE of the Dirichlet(1 + counts)
    mean (the likelihood's counts term is the only other factor on w, up
    to its 1e-8)."""
    _, tm = _models()
    before = dict(kernels.LAUNCHES)
    hmc_batched.reset_sync_count()
    g = torch.Generator().manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of tiny ops: threads only add overhead
    kernels.enable(kernels_on)
    try:
        draws, state, stats = tm.sample(
            g, n_chains=8, n_warmup=150, n_samples=150, max_depth=6, constrained=False
        )
    finally:
        kernels.enable(True)
        torch.set_num_threads(threads)
    assert draws.shape == (150, 8, tm.dim()) and torch.isfinite(draws).all()
    assert kernels.LAUNCHES == before  # a CPU state runs the plain versions
    n_leap = int(stats.n_steps.sum())
    assert 0 < hmc_batched.SYNCS["any_active"] <= 2 * n_leap + 4 * 300 * 7
    assert float(diagnostics.rhat(draws).max()) <= 1.1
    assert int(stats.diverging.sum()) <= 0.01 * stats.diverging.numel()
    w = tm.constrain(draws)["w"]
    assert w.shape == (150, 8, 4)
    mean = w.mean(dim=(0, 1)).numpy()
    post = (1.0 + COUNTS) / (4.0 + COUNTS.sum())
    np.testing.assert_array_less(np.abs(mean - post), 5.0 * diagnostics.mcse_mean(w))


def test_sample_raises_where_the_jax_package_takes_unported_paths():
    """Every init the JAX package's Model.sample takes is ported (the
    laplace and pathfinder inits run, their starts finite); an init it
    does not take raises as there."""
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jd.NamedProduct.of(
        mu=jd.Normal(0.0, 1.0), s=jd.LogNormal(0.0, 0.5))), **CPU64), device="cpu")
    g = torch.Generator().manual_seed(0)
    for init in ("laplace", "pathfinder"):
        raw, _, _ = tm.sample(g, n_chains=2, n_warmup=0, n_samples=1, init=init,
                              constrained=False)
        assert raw.shape == (1, 2, tm.dim()) and bool(torch.isfinite(raw).all())
    with pytest.raises(ValueError, match="unknown init"):
        tm.sample(g, n_chains=2, n_warmup=0, n_samples=1, init="prior")


def _picked(monkeypatch, model, jmodel):
    """The kernel names that Model.sample(kernel='auto') hands the sampler
    in the port and in the JAX package (their samplers stubbed out)."""
    seen = []

    def stub(fn, key, q0, n_warmup, n_samples, kernel, **kw):
        seen.append(kernel)
        return q0[None], None, None

    monkeypatch.setattr(sampler, "sample_with_kernel", stub)
    monkeypatch.setattr(jsampler, "sample_with_kernel", stub)
    model.sample(torch.Generator().manual_seed(0), n_chains=2, constrained=False)
    jmodel.sample(jax.random.PRNGKey(0), n_chains=2, constrained=False)
    return seen


@pytest.mark.parametrize("case", ["kernels_off", "bare_leaf"])
def test_auto_picks_nuts_batched_where_the_jax_package_does(monkeypatch, case):
    """Where the model has no fused plan (a bare leaf) or the kernels are
    off, kernel='auto' takes the batch-major `nuts_batched` in both
    packages (on the CPU the JAX package always takes it; the port takes
    `nuts_batched_t` wherever the fused plan serves, on either device)."""
    if case == "bare_leaf":
        jm = JModel(priors=jd.Normal(0.0, 1.0), loglik=lambda x: x)
        tm = tbt.Model(tbt.dists.Normal(0.0, 1.0, **CPU64), loglik=lambda x: x, device="cpu")
        assert _picked(monkeypatch, tm, jm) == ["nuts_batched", "nuts_batched"]
        return
    jm, tm = _models()
    assert _picked(monkeypatch, tm, jm) == ["nuts_batched_t", "nuts_batched"]
    kernels.enable(False)
    try:
        assert _picked(monkeypatch, tm, jm) == ["nuts_batched", "nuts_batched"]
    finally:
        kernels.enable(True)
