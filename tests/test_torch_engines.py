"""The port's parallel tempering, ensemble sampler, SBC and predictive
checks against the JAX package, float64 on the CPU.

Deterministic pieces on the same inputs (1e-10): `default_ladder`,
`sbc_uniformity` on the same ranks (calibrated, under-dispersed, biased,
an exactly uniform sample on uneven bins) and `ppc_pvalue` on the same
arrays. Whole runs of the port against exact answers, the JAX tests'
cases and tolerances (tests/test_tempering.py, test_ensemble.py,
test_sbc.py, test_predictive.py) with fewer sweeps where the CPU's host
loop needs it: PT's bimodal mode recovery, its Beta-Binomial moments
through `Model` and a live beta = 0 rung where the likelihood is -inf;
the ensemble on a correlated, badly scaled Gaussian and a
non-differentiable target; SBC's calibrated normal model; the prior
predictive's moments and the posterior predictive's shapes. And the
errors both packages raise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bijectors.infer import default_ladder as j_default_ladder
from tpu_bijectors.infer import ppc_pvalue as j_ppc_pvalue
from tpu_bijectors.infer import run_ensemble as j_run_ensemble
from tpu_bijectors.infer import sbc_uniformity as j_sbc_uniformity

from tpu_bijectors_torch import dists
from tpu_bijectors_torch.infer import (
    Model,
    default_ladder,
    posterior_predictive,
    ppc_pvalue,
    prior_predictive,
    run_ensemble,
    run_parallel_tempering,
    sbc_ranks,
    sbc_uniformity,
)
from tpu_bijectors_torch.infer import hmc_batched

TOL = dict(rtol=1e-10, atol=1e-10)
F64 = torch.float64
KW = dict(device="cpu", dtype=F64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _batch(f):
    f.batch_capable = True
    return f


# ---------------------------------------------------------------------------
# parallel tempering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 6, 8])
def test_default_ladder_matches_jax(n):
    b = default_ladder(n)
    np.testing.assert_allclose(b.numpy(), np.asarray(j_default_ladder(n)), **TOL)
    assert float(b[-1]) == 1.0 and (n == 1 or float(b[0]) == 0.0)
    assert bool(torch.all(torch.diff(b) > 0))


@_batch
def _bimodal_prior(v):
    return -0.5 * torch.sum((v / 3.0) ** 2, -1) - math.log(3.0 * math.sqrt(2 * math.pi))


@_batch
def _bimodal_lik(v):
    modes = torch.stack([-0.5 * torch.sum(((v - 4.0) / 0.5) ** 2, -1),
                         -0.5 * torch.sum(((v + 4.0) / 0.5) ** 2, -1)])
    return torch.logsumexp(modes, 0) - math.log(2.0)


def test_pt_bimodal_mode_recovery():
    """Every chain starts in one mode; the cold chain holds both with about
    equal mass, at +-4, and every pair swaps. The run reads nothing back
    to the host (SYNCS unchanged)."""
    before = dict(hmc_batched.SYNCS)
    res = run_parallel_tempering(_bimodal_prior, _bimodal_lik, _gen(0),
                                 torch.full((32, 1), 4.0, dtype=F64), n_temps=8,
                                 n_warmup=100, n_samples=200, n_leapfrog=8)
    assert hmc_batched.SYNCS == before
    draws = res.samples.reshape(-1).numpy()
    assert res.samples.shape == (200, 32, 1)
    assert 0.3 < float((draws < 0).mean()) < 0.7
    assert abs(np.abs(draws).mean() - 4.0) < 0.3
    assert res.swap_accept.shape == (7,) and bool(torch.all(res.swap_accept > 0.1))
    assert res.accept.shape == (8,) and res.eps.shape == (8,)


def test_pt_on_model_linked_densities():
    """PT through the vectorize layer (Model's prior and a likelihood on
    the constrained p): the Beta-Binomial posterior mean."""
    a, b, n_trials, heads = 2.0, 2.0, 50, 17
    model = Model(dists.NamedProduct.of(p=dists.Beta(a, b, **KW)), device="cpu")

    @_batch
    def log_lik(v):
        p = model.constrain(v)["p"]
        return heads * torch.log(p) + (n_trials - heads) * torch.log1p(-p)

    g = _gen(2)
    res = run_parallel_tempering(model.batched_logdensity_fn(), log_lik, g,
                                 torch.randn((32, 1), generator=g, dtype=F64), n_temps=6,
                                 n_warmup=80, n_samples=150, n_leapfrog=8)
    p = model.constrain(res.samples.reshape(-1, 1))["p"]
    a_post, b_post = a + heads, b + n_trials - heads
    np.testing.assert_allclose(float(p.mean()), a_post / (a_post + b_post), atol=0.03)


def test_pt_zero_likelihood_region_beta0_stays_alive():
    """The beta = 0 rung wanders where log lik = -inf: it keeps moving, the
    cold chain keeps v > 0 with the half-normal's mean, and the TI
    evidence is -inf, never NaN."""

    @_batch
    def logp(v):
        return -0.5 * torch.sum(v * v, -1)

    @_batch
    def loglik(v):
        return torch.where(v[..., 0] > 0, 0.0, -torch.inf).to(v.dtype)

    g = _gen(1)
    res = run_parallel_tempering(logp, loglik, g,
                                 torch.abs(torch.randn((16, 1), generator=g, dtype=F64)),
                                 n_temps=8, n_warmup=150, n_samples=250, n_leapfrog=8)
    x = res.samples.reshape(-1)
    assert bool(torch.all(torch.isfinite(x)) and torch.all(x > 0))
    assert not math.isnan(float(res.log_evidence))
    assert bool(torch.all(torch.isfinite(res.eps)))
    assert float(res.accept[0]) > 0.2
    np.testing.assert_allclose(float(x.mean()), math.sqrt(2 / math.pi), atol=0.1)


def test_pt_axis_name_not_ported():
    with pytest.raises(NotImplementedError, match="shard"):
        run_parallel_tempering(_bimodal_prior, _bimodal_lik, _gen(0),
                               torch.zeros((4, 1), dtype=F64), axis_name="chains")


# ---------------------------------------------------------------------------
# the ensemble sampler
# ---------------------------------------------------------------------------


def test_ensemble_correlated_badly_scaled_gaussian():
    """Condition number 1e4 and correlation 0.9: the stretch move needs no
    tuning."""
    sd = np.array([100.0, 0.5])
    rho = 0.9
    cov = np.array([[sd[0] ** 2, rho * sd[0] * sd[1]], [rho * sd[0] * sd[1], sd[1] ** 2]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    mean = torch.tensor([3.0, -1.0], dtype=F64)

    @_batch
    def logp(v):
        d = v - mean
        return -0.5 * torch.einsum("...i,ij,...j->...", d, prec, d)

    g = _gen(1)
    res = run_ensemble(logp, g, mean + torch.randn((64, 2), generator=g, dtype=F64),
                       n_warmup=600, n_samples=1500)
    draws = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose((draws.mean(0) - mean.numpy()) / sd, 0.0, atol=0.1)
    np.testing.assert_allclose(np.cov(draws.T), cov, rtol=0.15, atol=0.05)
    assert 0.1 < float(res.accept_rate) < 0.9
    assert res.logp.shape == (1500, 64)


def test_ensemble_nondifferentiable_target():
    """Laplace(0, b): no gradient at 0, variance 2 b^2."""
    b = 1.5

    @_batch
    def logp(v):
        return -torch.sum(torch.abs(v), -1) / b

    g = _gen(3)
    res = run_ensemble(logp, g, torch.randn((64, 1), generator=g, dtype=F64),
                       n_warmup=1000, n_samples=3000)
    draws = res.samples.reshape(-1).numpy()
    np.testing.assert_allclose(draws.mean(), 0.0, atol=0.15)
    np.testing.assert_allclose(draws.var(), 2 * b * b, rtol=0.15)


def test_ensemble_walker_validation_as_jax():
    def logp(v):
        return -0.5 * torch.sum(v * v)

    def jlogp(v):
        return -0.5 * jnp.sum(v * v)

    for n, match in ((5, "even"), (2, "at least 4")):
        with pytest.raises(ValueError, match=match):
            run_ensemble(logp, _gen(0), torch.zeros((n, 2), dtype=F64))
        with pytest.raises(ValueError, match=match):
            j_run_ensemble(jlogp, jax.random.PRNGKey(0), jnp.zeros((n, 2)))


# ---------------------------------------------------------------------------
# SBC
# ---------------------------------------------------------------------------


def _analytic_ranks(rng, n_sims, n_draws, sd_scale=1.0, n_obs=5):
    """Normal-Normal conjugate: theta0's rank among draws from the exact
    posterior with its sd times sd_scale (1.0 = calibrated)."""
    ranks = np.empty(n_sims, np.int64)
    for i in range(n_sims):
        theta0 = rng.standard_normal()
        y = theta0 + rng.standard_normal(n_obs)
        prec = 1.0 + n_obs
        draws = y.sum() / prec + sd_scale / np.sqrt(prec) * rng.standard_normal(n_draws)
        ranks[i] = np.sum(draws < theta0)
    return ranks[:, None]


def test_sbc_uniformity_matches_jax(rng):
    """The same p-values (1e-10) on calibrated, under-dispersed and biased
    ranks, and an exactly uniform sample on bins that do not divide the
    rank range (statistic 0, p = 1)."""
    n_sims, n_draws = 256, 127
    good = _analytic_ranks(rng, n_sims, n_draws)
    bad = _analytic_ranks(rng, n_sims, n_draws, sd_scale=0.5)
    biased = np.clip(_analytic_ranks(rng, n_sims, n_draws) + n_draws // 4, 0, n_draws)
    cases = [(np.concatenate([good, bad, biased], 1), n_draws, None)]
    cases.append((np.tile(np.arange(129), 4)[:, None], 128, 8))
    for ranks, L, bins in cases:
        p = sbc_uniformity(torch.as_tensor(ranks), L, bins)
        jp = jax.jit(j_sbc_uniformity, static_argnums=(1, 2))(jnp.asarray(ranks), L, bins)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)
    p = sbc_uniformity(torch.as_tensor(cases[0][0]), n_draws).numpy()
    assert p[0] > 0.01 and p[1] < 1e-4 and p[2] < 1e-4
    assert float(sbc_uniformity(torch.as_tensor(cases[1][0]), 128, 8)[0]) > 0.999


N_OBS_SBC = 5


def _sbc_model():
    prior = dists.NamedProduct.of(mu=dists.Normal(0.0, 1.0, **KW),
                                  tau=dists.LogNormal(0.0, 0.5, **KW))

    def simulate(generator, x):
        z = torch.randn((x["mu"].shape[0], N_OBS_SBC), generator=generator, dtype=F64)
        return x["mu"][:, None] + x["tau"][:, None] * z

    def loglik(y, x):
        return torch.sum(-0.5 * ((y - x["mu"]) / x["tau"]) ** 2 - torch.log(x["tau"]))

    return prior, simulate, loglik


def test_sbc_nuts_normal_model():
    """One batched-NUTS study on mu ~ N(0, 1), tau ~ LogNormal(0, 0.5),
    y ~ N(mu, tau): both linked coordinates calibrated."""
    prior, simulate, loglik = _sbc_model()
    res = sbc_ranks(prior, simulate, loglik, _gen(23), n_sims=96, n_warmup=100,
                    n_samples=128, thin=2)
    assert res.ranks.shape == (96, 2) and res.n_draws == 64
    assert int(res.ranks.min()) >= 0 and int(res.ranks.max()) <= 64
    assert res.theta0["mu"].shape == (96,)
    p = sbc_uniformity(res.ranks, res.n_draws).numpy()
    assert np.all(p > 0.005), p


# ---------------------------------------------------------------------------
# predictive checks
# ---------------------------------------------------------------------------

N_OBS = 20


def _simulate(generator, x, noise=1.0):
    mu = x["mu"]
    return mu[:, None] + noise * torch.randn((mu.shape[0], N_OBS), generator=generator,
                                             dtype=mu.dtype)


def test_prior_predictive_moments():
    """mu ~ N(0, 2), y | mu ~ N(mu, 1): the prior predictive's variance is
    4 + 1."""
    prior = dists.NamedProduct.of(mu=dists.Normal(0.0, 2.0, **KW))
    theta, y = prior_predictive(prior, _simulate, _gen(23), 4000)
    assert theta["mu"].shape == (4000,) and y.shape == (4000, N_OBS)
    np.testing.assert_allclose(float(y.mean()), 0.0, atol=0.15)
    np.testing.assert_allclose(float(y.var()), 5.0, rtol=0.1)


def test_posterior_predictive_and_ppc():
    """Exact posterior draws of the Normal-Normal model laid out as
    (draws, chains): has_chains inferred, the PPC moderate for the true
    model and extreme for one with three times the noise; a flat (draws,)
    tree too."""
    rng = np.random.default_rng(3)
    y_obs = torch.as_tensor(1.5 + rng.standard_normal(N_OBS))
    prec = 1.0 / 4.0 + N_OBS
    mu = float(y_obs.sum()) / prec + rng.standard_normal((500, 8)) / np.sqrt(prec)
    samples = {"mu": torch.as_tensor(mu)}
    y_rep = posterior_predictive(_simulate, samples, _gen(1))
    assert y_rep.shape == (8 * 500, N_OBS)
    p_mean = float(ppc_pvalue(torch.mean, y_obs, y_rep))
    assert 0.05 < p_mean < 0.95
    y_bad = posterior_predictive(lambda g, x: _simulate(g, x, 3.0), samples, _gen(2))
    p_sd = float(ppc_pvalue(lambda y: torch.std(y, correction=0), y_obs, y_bad))
    assert p_sd > 0.99
    flat = {"mu": torch.linspace(-1.0, 1.0, 64, dtype=F64)}
    assert posterior_predictive(_simulate, flat, _gen(3)).shape == (64, N_OBS)
    vec = {"w": torch.zeros((64, 3), dtype=F64)}
    got = posterior_predictive(lambda g, x: x["w"], vec, _gen(3), has_chains=False)
    assert got.shape == (64, 3)


def test_ppc_pvalue_matches_jax():
    """The same p-value on the same observed and replicated arrays, and on
    exact ties of the maximum (>=; a sum's ties hang on its reduction
    order, so the mean and sd see none)."""
    rng = np.random.default_rng(5)
    obs = rng.standard_normal(N_OBS)
    rep = rng.standard_normal((300, N_OBS))
    tied = rep.copy()
    tied[::7, 3] = obs.max() + 1.0
    tied[::7] = np.minimum(tied[::7], obs.max())
    for stat, jstat, r in ((torch.mean, jnp.mean, rep),
                           (lambda y: torch.std(y, correction=0), jnp.std, rep),
                           (torch.amax, jnp.max, rep), (torch.amax, jnp.max, tied)):
        p = ppc_pvalue(stat, torch.as_tensor(obs), torch.as_tensor(r))
        jp = jax.jit(lambda o, r, s=jstat: j_ppc_pvalue(s, o, r))(jnp.asarray(obs),
                                                                   jnp.asarray(r))
        np.testing.assert_allclose(float(p), float(jp), **TOL)
        assert p.dtype == F64



def test_exports_match_jax():
    """The new modules' names, exported where the JAX package exports
    them: `infer` (tempering, ensemble, SBC, predictive, NeuTra, the flow
    posterior) and the package root (the four flow layers, `flows`)."""
    import tpu_bijectors as jtb
    import tpu_bijectors.infer as jinfer

    import tpu_bijectors_torch as tbt
    import tpu_bijectors_torch.infer as tinfer

    names = ("run_parallel_tempering", "PTResult", "default_ladder", "run_ensemble",
             "EnsembleResult", "neutra_logdensity", "fit_neutra_flow", "neutra_sample",
             "NeutraResult", "sbc_ranks", "sbc_uniformity", "SBCResult", "prior_predictive",
             "posterior_predictive", "ppc_pvalue", "FlowPosterior")
    for n in names:
        assert n in jinfer.__all__ and n in tinfer.__all__ and hasattr(tinfer, n), n
    for n in ("InvertibleBatchNorm", "PlanarLayer", "RadialLayer", "RationalQuadraticSpline",
              "flows"):
        assert hasattr(jtb, n) and hasattr(tbt, n), n
