"""The port's SMC and ADVI against the JAX package, float64 on the CPU.

Pieces on the same numpy or JAX draws (1e-12; 1e-10 through an optimiser
step): systematic resampling given its uniform, the ESS and the next
temperature's bisection; the ADVI families' draws, log-densities and
entropies given the standard normals; the negative ELBO and its gradient
for every estimator and layout (the JAX package's through one step of
`fit_advi` with SGD at rate 1, which leaves q minus the gradient), and
Adam's steps against `optax.adam`'s. Whole runs with the JAX tests' own
tolerances: SMC on the conjugate Gaussian in both layouts with both
mutations (its evidence is known), ADVI on the Beta-Binomial in both
layouts, and the errors both packages raise.

As a script it runs the JAX package's float64 `run_smc` on the CPU with
`chip_smoke.py`'s path 21 (eight schools, the prior's draws at
chip_smoke.SMC_N, its SMC_* settings, transposed, HMC mutation) and prints
one JSON line a seed, then the mean log evidence and its spread (the
standard deviation over the seeds), which the path holds the port's to
(`chip_smoke.SMC_LOGEV_JAX`):

    python tests/test_torch_smc_advi.py --engine jax --seeds 0 1 2 3
"""

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpu_bijectors.infer import FullRankGaussian as JFullRank
from tpu_bijectors.infer import MeanFieldGaussian as JMeanField
from tpu_bijectors.infer import Model as JModel
from tpu_bijectors.infer import fit_advi as jfit_advi
from tpu_bijectors.infer import smc as jsmc

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists
from tpu_bijectors_torch.infer import (
    FlowPosterior,
    FullRankGaussian,
    MeanFieldGaussian,
    advi,
    fit_advi,
    run_smc,
    smc,
)

TOL = dict(rtol=1e-12, atol=1e-12)
OPT_TOL = dict(rtol=1e-10, atol=1e-10)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ---------------------------------------------------------------------------
# SMC's pieces
# ---------------------------------------------------------------------------


_j_resample = jax.jit(jsmc.systematic_resample)


def test_systematic_resample_matches_jax(rng):
    """Parent indices given the JAX draw's uniform, on weights with a
    zero-weight prefix and a spread of scales; u0 = 0 skips the prefix and
    u0 just below 1 stays inside the block."""
    lw = 3.0 * rng.standard_normal(257)
    lw[:4] = -np.inf
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(_j_resample(key, jnp.asarray(lw)))
        u0 = np.asarray(jax.random.uniform(key, (), jnp.float64))
        got = smc._systematic_resample(torch.as_tensor(lw), torch.tensor(float(u0), dtype=F64))
        np.testing.assert_array_equal(got.numpy(), ref)
    prefix = torch.tensor([-np.inf, 0.0, 0.0, 0.0], dtype=F64)
    assert bool((smc._systematic_resample(prefix, torch.tensor(0.0, dtype=F64)) >= 1).all())
    top = smc._systematic_resample(torch.zeros(5, dtype=F64),
                                   torch.tensor(1.0 - 1e-16, dtype=F64))
    assert int(top.max()) == 4
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        assert bool((smc.systematic_resample(g, prefix) >= 1).all())


_j_ess = jax.jit(jsmc.ess)
_j_next_beta = jax.jit(jsmc._find_next_beta, static_argnums=2)


@pytest.mark.parametrize("beta", [0.0, 0.3, 0.999999])
@pytest.mark.parametrize("target", [0.5, 0.9])
def test_ess_and_next_beta_match_jax(rng, beta, target):
    ll = 4.0 * rng.standard_normal(500) - 2.0
    ll_inf = ll.copy()
    ll_inf[: 300] = -np.inf  # the ESS target out of reach: the minimal step
    for x in (ll, ll_inf):
        np.testing.assert_allclose(smc.ess(torch.as_tensor(0.7 * x)).numpy(),
                                   np.asarray(_j_ess(jnp.asarray(0.7 * x))), **TOL)
        got = smc._find_next_beta(torch.as_tensor(x), torch.tensor(beta, dtype=F64), target)
        ref = _j_next_beta(jnp.asarray(x), jnp.asarray(beta), target)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# ADVI's pieces
# ---------------------------------------------------------------------------

DIM = 3


def _families(rng):
    """A mean-field and a full-rank Gaussian of random parameters, in both
    packages."""
    loc, log_scale = rng.standard_normal(DIM), 0.3 * rng.standard_normal(DIM)
    tril = 0.4 * rng.standard_normal((DIM, DIM))
    return {
        "meanfield": (JMeanField(jnp.asarray(loc), jnp.asarray(log_scale)),
                      MeanFieldGaussian(torch.as_tensor(loc), torch.as_tensor(log_scale))),
        "fullrank": (JFullRank(jnp.asarray(loc), jnp.asarray(tril)),
                     FullRankGaussian(torch.as_tensor(loc), torch.as_tensor(tril))),
    }


@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
def test_families_match_jax(rng, family):
    jq, q = _families(rng)[family]
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (7, DIM), jnp.float64))
    v = q._from_eps(torch.as_tensor(eps))
    np.testing.assert_allclose(v.numpy(), np.asarray(jq.sample(key, 7)), **TOL)
    eps_t = np.array(jax.random.normal(key, (DIM, 7), jnp.float64))
    np.testing.assert_allclose(q._from_eps_t(torch.as_tensor(eps_t)).numpy(),
                               np.asarray(jq.sample_t(key, 7)), **TOL)
    np.testing.assert_allclose(q.logdensity(v).numpy(),
                               np.asarray(jq.logdensity(jnp.asarray(v.numpy()))), **TOL)
    vv = v.reshape(7, 1, DIM)  # leading batch axes
    np.testing.assert_allclose(q.logdensity(vv).numpy(),
                               np.asarray(jq.logdensity(jnp.asarray(vv.numpy()))), **TOL)
    np.testing.assert_allclose(q.entropy().numpy(), np.asarray(jq.entropy()), **TOL)
    g = torch.Generator().manual_seed(0)
    assert q.sample(g, 5).shape == (5, DIM) and q.sample_t(g, 5).shape == (DIM, 5)


_PREC = np.array([[2.0, 0.6, 0.1], [0.6, 1.0, -0.3], [0.1, -0.3, 0.8]])
_MU = np.array([0.5, -1.0, 0.2])


def _targets():
    """A correlated Gaussian in both packages and both layouts (batch-capable)."""
    P, mu = torch.as_tensor(_PREC), torch.as_tensor(_MU)
    jP, jmu = jnp.asarray(_PREC), jnp.asarray(_MU)

    def t_rows(v):
        r = v - mu
        return -0.5 * torch.sum((r @ P) * r, -1)

    def t_cols(vT):
        r = vT - mu[:, None]
        return -0.5 * torch.sum((P @ r) * r, 0)

    def j_rows(v):
        r = v - jmu
        return -0.5 * jnp.sum((r @ jP) * r, -1)

    def j_cols(vT):
        r = vT - jmu[:, None]
        return -0.5 * jnp.sum((jP @ r) * r, 0)

    for f in (t_rows, t_cols, j_rows, j_cols):
        f.batch_capable = True
    return {False: (j_rows, t_rows), True: (j_cols, t_cols)}


def _eps_of(key, n_steps, shape):
    return [np.array(jax.random.normal(k, shape, jnp.float64))
            for k in jax.random.split(key, n_steps)]


@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
@pytest.mark.parametrize("estimator,transposed",
                         [("elbo", False), ("elbo", True), ("stl", False), ("stl", True),
                          ("iwelbo", False)])
def test_negative_elbo_and_gradient_match_jax(rng, family, estimator, transposed):
    """The loss and its gradient in q's fields on the same draws: the JAX
    package's from one `fit_advi` step with SGD at rate 1 (loss in
    `losses`, gradient = q - q')."""
    jq, q = _families(rng)[family]
    jlogp, logp = _targets()[transposed]
    n_mc, n_iw = 8, 4
    key = jax.random.PRNGKey(11)
    res = jfit_advi(jlogp, key, DIM, q=jq, n_steps=1, n_mc=n_mc, optimizer=optax.sgd(1.0),
                    dtype=jnp.float64, transposed=transposed, estimator=estimator, n_iw=n_iw)
    n = n_mc * n_iw if estimator == "iwelbo" else n_mc
    (eps,) = _eps_of(key, 1, (DIM, n) if transposed else (n, DIM))
    params = [t.clone().requires_grad_(True) for t in q]
    loss = advi._neg_elbo(type(q)(*params), logp, torch.as_tensor(eps), estimator, transposed,
                          n_iw)
    loss.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(res.losses[0]), **TOL)
    for p, f in zip(params, q._fields):
        ref = np.asarray(getattr(jq, f)) - np.asarray(getattr(res.q, f))
        np.testing.assert_allclose(p.grad.numpy(), ref, **TOL)


@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimiser_steps_match_optax(rng, family, opt):
    """Three steps of the default optimiser (torch's Adam at optax.adam's
    defaults) and of a `torch.optim` factory passed as `optimizer`
    (SGD) against the JAX package's fit_advi with optax.adam and
    optax.sgd on the same draws (1e-10)."""
    jq, q = _families(rng)[family]
    jlogp, logp = _targets()[False]
    key = jax.random.PRNGKey(5)
    res = jfit_advi(jlogp, key, DIM, q=jq, n_steps=3, n_mc=8, learning_rate=0.05,
                    optimizer=None if opt == "adam" else optax.sgd(0.05),
                    dtype=jnp.float64, estimator="stl")
    eps = [torch.as_tensor(e) for e in _eps_of(key, 3, (8, DIM))]
    factory = advi._adam(0.05) if opt == "adam" else (
        lambda params: torch.optim.SGD(params, lr=0.05))
    got = advi._fit(q, logp, factory, eps, "stl", False, 8)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(res.losses), **OPT_TOL)
    for f in q._fields:
        np.testing.assert_allclose(getattr(got.q, f).numpy(), np.asarray(getattr(res.q, f)),
                                   **OPT_TOL)


def test_fit_advi_raises_as_jax():
    jlogp, logp = _targets()[False]

    def per_sample(v):
        return -0.5 * torch.sum(v * v)

    cases = [dict(estimator="bogus"), dict(estimator="iwelbo", transposed=True)]
    for kw in cases:
        with pytest.raises(ValueError):
            fit_advi(logp, torch.Generator(), DIM, device="cpu", **kw)
        with pytest.raises(ValueError):
            jfit_advi(jlogp, jax.random.PRNGKey(0), DIM, **kw)
    with pytest.raises(ValueError, match="batch-capable"):
        fit_advi(per_sample, torch.Generator(), DIM, transposed=True, device="cpu")
    # a flow posterior: the Gaussian-only estimator and layout raise in both
    flow = tbt.flows.maf_stack(torch.Generator().manual_seed(0), DIM, n_layers=1, hidden=4,
                               device="cpu", dtype=F64)
    for kw in (dict(estimator="stl"), dict(transposed=True)):
        with pytest.raises(ValueError, match="Gaussian families only"):
            fit_advi(logp, torch.Generator(), DIM, q=FlowPosterior(flow), **kw)


# ---------------------------------------------------------------------------
# whole runs, in distribution (the JAX tests' tolerances)
# ---------------------------------------------------------------------------

X_OBS, S_LIK = 1.0, 0.5
POST_VAR = 1.0 / (1.0 + 1.0 / S_LIK**2)
POST_MEAN = POST_VAR * X_OBS / S_LIK**2
EXACT_LOGEV = -0.5 * X_OBS**2 / (1 + S_LIK**2) - 0.5 * np.log(2 * np.pi * (1 + S_LIK**2))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("mutation", ["rwm", "hmc"])
def test_smc_conjugate_gaussian_evidence(transposed, mutation):
    """Prior N(0, 1), likelihood N(1 | theta, 0.5): the posterior's moments
    and the exact log evidence (tests/test_inference.py::
    test_smc_gaussian_evidence and test_smc_transposed_matches)."""
    ax = 0 if transposed else -1

    def log_prior(v):
        return -0.5 * torch.sum(v * v, ax) - 0.5 * np.log(2 * np.pi)

    def log_lik(v):
        x = v[0] if transposed else v[..., 0]
        return -0.5 * ((X_OBS - x) / S_LIK) ** 2 - np.log(S_LIK * np.sqrt(2 * np.pi))

    if transposed:
        log_prior.batch_capable = log_lik.batch_capable = True
    g = torch.Generator().manual_seed(11)
    n = 4096
    p0 = torch.randn((1, n) if transposed else (n, 1), generator=g, dtype=F64)
    res = run_smc(log_prior, log_lik, g, p0, n_mutations=10, rw_scale=0.5, mutation=mutation,
                  hmc_eps=0.4, hmc_leapfrog=8, transposed=transposed)
    assert res.particles.shape == p0.shape
    p = res.particles.reshape(-1).numpy()
    np.testing.assert_allclose(p.mean(), POST_MEAN, atol=0.05)
    np.testing.assert_allclose(p.var(), POST_VAR, rtol=0.2)
    np.testing.assert_allclose(float(res.log_evidence), EXACT_LOGEV, atol=0.1)
    assert float(res.final_beta) == 1.0
    if transposed:
        with pytest.raises(ValueError, match="batch-capable"):
            run_smc(lambda v: v.sum(), lambda v: v.sum(), g, p0, transposed=True)


def test_smc_zero_likelihood_region_progresses():
    """Most of the prior mass at log_lik = -inf: the strict-progress guard
    tempers through (tests/test_inference.py::
    test_smc_zero_likelihood_region_progresses)."""
    def logp(v):
        return -0.5 * torch.sum(v * v, -1)

    def loglik(v):
        return torch.where(v[..., 0] > 0, 0.0, -torch.inf).to(v.dtype)

    g = torch.Generator().manual_seed(1)
    p0 = torch.randn((2048, 1), generator=g, dtype=F64)
    res = run_smc(logp, loglik, g, p0, n_mutations=5, rw_scale=0.5)
    np.testing.assert_allclose(float(res.log_evidence), np.log(0.5), atol=0.1)
    assert float(res.final_beta) == 1.0
    parts = res.particles.numpy()
    assert np.all(parts > 0)
    np.testing.assert_allclose(parts.mean(), np.sqrt(2 / np.pi), atol=0.08)


def _beta_binomial():
    return tbt.Model(
        dists.NamedProduct.of(p=dists.Beta(2.0, 2.0, device="cpu", dtype=F64)),
        loglik=lambda x: 17 * torch.log(x["p"]) + 33 * torch.log1p(-x["p"]),
        device="cpu",
    )


@pytest.mark.parametrize("transposed", [False, True])
def test_advi_beta_binomial(transposed):
    """The Beta(19, 35) posterior's mean through the unconstraining map, from
    the per-example density batch-major and the transposed one
    (tests/test_inference.py::test_advi_transformed_model and
    test_advi_transposed_matches)."""
    model = _beta_binomial()
    fn = model.batched_logdensity_t_fn() if transposed else model.logdensity_fn()
    g = torch.Generator().manual_seed(3)
    res = fit_advi(fn, g, model.dim(), n_steps=1500, n_mc=16 if transposed else 32,
                   learning_rate=2e-2, dtype=F64, transposed=transposed, device="cpu")
    p = model.constrain(res.q.sample(g, 4000))["p"]
    np.testing.assert_allclose(float(p.mean()), 19.0 / 54.0, atol=0.03)
    assert float(res.losses[-100:].mean()) < float(res.losses[:100].mean())


# ---------------------------------------------------------------------------
# the script: the JAX package's float64 SMC on path 21's eight schools
# ---------------------------------------------------------------------------


def run_jax_smc(seed):
    import chip_smoke
    from test_torch_eight_schools import jax_model

    from tpu_bijectors.infer import run_smc as jrun_smc

    m = jax_model()
    u = m.unconstrainer()
    prior = JModel(priors=m.priors).batched_logdensity_t_fn()
    y, sig = jnp.asarray(chip_smoke.ES_Y), jnp.asarray(chip_smoke.ES_SIGMA)

    def lik(vT):
        x = u.from_linked_vec(jnp.swapaxes(vT, 0, 1))[0]
        th = x["mu"][:, None] + x["tau"][:, None] * x["theta_raw"]
        return jnp.sum(-0.5 * ((y - th) / sig) ** 2, -1)

    lik.batch_capable = True
    n = chip_smoke.SMC_N
    k0, k1, k2, k_run = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = {"mu": 5.0 * jax.random.normal(k0, (n,)),
         "tau": 5.0 * jnp.abs(jax.random.cauchy(k1, (n,))),
         "theta_raw": jax.random.normal(k2, (n, 8))}
    p0 = jnp.swapaxes(u.to_linked_vec(x)[0], 0, 1)
    t0 = time.perf_counter()
    res = jax.jit(lambda k, p: jrun_smc(
        prior, lik, k, p, n_mutations=chip_smoke.SMC_MUTATIONS,
        target_ess=chip_smoke.SMC_TARGET_ESS, mutation="hmc", hmc_eps=chip_smoke.SMC_EPS,
        hmc_leapfrog=chip_smoke.SMC_LEAPFROG, transposed=True))(k_run, p0)
    xs = u.from_linked_vec(jnp.swapaxes(res.particles, 0, 1))[0]
    return {"seed": seed, "log_evidence": float(res.log_evidence),
            "stages": int(res.n_stages), "final_beta": float(res.final_beta),
            "mu_mean": float(xs["mu"].mean()), "tau_mean": float(xs["tau"].mean()),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=["jax"], default="jax")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    evs = []
    for seed in args.seeds:
        line = run_jax_smc(seed)
        evs.append(line["log_evidence"])
        print(json.dumps(line), flush=True)
    print(json.dumps({"log_evidence_mean": float(np.mean(evs)),
                      "log_evidence_spread": float(np.std(evs, ddof=1)) if len(evs) > 1
                      else None}), flush=True)


if __name__ == "__main__":
    main()
