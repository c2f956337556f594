"""The port's Pathfinder, PSIS-LOO / WAIC and evidence estimators against the
JAX package, float64 on the CPU.

Pieces on the JAX package's own inputs and draws (1e-10): the compact
factors against a dense inverse-BFGS oracle, masked pairs, draws and
log q given the standard normals, the diagonal update, and a whole
`fit_pathfinder` run's candidate ELBOs, best candidate and draws given
the JAX run's normals; whole runs at `tests/test_pathfinder.py`'s
tolerances (a Gaussian target, the Beta-Binomial through multi-path, a
batch-capable density). `fit_gpd`, `psis_loo`, `waic` on the same inputs;
both evidence estimators on the same proposal draws (a Laplace Gaussian
and the ADVI Gaussians), and against the analytic evidence.
`Model.sample(init='pathfinder')`'s starts and inverse mass.

As a script it computes, with the JAX package in float64 on the CPU, the
reference numbers `chip_smoke.py`'s paths 23 and 24 hold the port to, on
the bench model with `chip_smoke.hier_loglik_and_counts`'s likelihood:
`map_laplace` (200 steps from zeros: lp at the MAP, the MAP, the Laplace
evidence), `importance_sampling_evidence` with that Laplace proposal at
n = 4096, `fit_pathfinder` from zeros and `multipath_pathfinder` from 8
starts at 0.3 N(0, 1) at their defaults (the best ELBO, the `w` block's
means; multi-path's importance ESS), one JSON line a seed, then the
means and spreads (standard deviations over the seeds; for `w`, pooled
over its coordinates in units of their posterior sd) as
`chip_smoke.LAPLACE_JAX` and `PATHFINDER_JAX`;
with `--dtype float32` (x64 off) Pathfinder's in float32, as
`chip_smoke.PATHFINDER_JAX_F32`:

    python tests/test_torch_pathfinder_evidence.py --engine jax --seeds 0 1 2 3 4 5 6 7
    python tests/test_torch_pathfinder_evidence.py --engine jax --dtype float32
"""

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_fused import CPU64, spec_of

from tpu_bijectors import dists as jd
from tpu_bijectors.infer import FullRankGaussian as JFullRank
from tpu_bijectors.infer import LaplaceApprox as JLaplaceApprox
from tpu_bijectors.infer import MeanFieldGaussian as JMeanField
from tpu_bijectors.infer import Model as JModel
from tpu_bijectors.infer import bridge_sampling_evidence as jbridge
from tpu_bijectors.infer import fit_gpd as jfit_gpd
from tpu_bijectors.infer import fit_pathfinder as jfit_pathfinder
from tpu_bijectors.infer import importance_sampling_evidence as jis
from tpu_bijectors.infer import map_laplace as jmap_laplace
from tpu_bijectors.infer import psis_loo as jpsis_loo
from tpu_bijectors.infer import waic as jwaic
from tpu_bijectors.infer import pathfinder as jpf

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.infer import (
    FullRankGaussian,
    MeanFieldGaussian,
    bridge_sampling_evidence,
    fit_gpd,
    fit_pathfinder,
    importance_sampling_evidence,
    map_laplace,
    multipath_pathfinder,
    psis_loo,
    waic,
)
from tpu_bijectors_torch.infer import evidence as tev
from tpu_bijectors_torch.infer import pathfinder as tpf

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Pathfinder's pieces
# ---------------------------------------------------------------------------


def _history(rng, dim, j):
    """Curvature pairs of a quadratic (z = H s, H SPD) and a diagonal."""
    a = rng.standard_normal((dim, dim))
    h = a @ a.T + dim * np.eye(dim)
    S = rng.standard_normal((j, dim))
    return S, S @ h.T, rng.uniform(0.5, 2.0, dim)


@jax.jit
def _jax_pieces(key, S, Z, mask, alpha, mu, y, s, z):
    b, g = jpf._factors(S, Z, mask, alpha)
    x, lq = jpf._sample_and_logq(key, mu, alpha, b, g, 40)
    q, ell, hld = jpf._sqrt_pieces(alpha, b, g)
    return (b, g, x, lq, hld, jpf._logq(y, mu, alpha, q, ell, hld),
            jpf._alpha_update(alpha, s, z))


def test_factors_and_draws_match_jax(rng, key):
    """beta, gamma, the draws and log q on the JAX package's normals, half
    log|Sigma|, log q of foreign points and the diagonal update (one jitted
    JAX call); Sigma and Sigma g against the textbook inverse-BFGS
    recursion."""
    dim, j = 5, 3
    S, Z, alpha = _history(rng, dim, j)
    mask = np.ones(j, bool)
    mu, y = rng.standard_normal(dim), rng.standard_normal((7, dim))
    s, z = rng.standard_normal(dim), rng.standard_normal(dim)
    ref = _jax_pieces(key, *(jnp.asarray(a) for a in (S, Z, mask, alpha, mu, y, s, z)))
    b, g = tpf._factors(_t(S), _t(Z), _t(mask), _t(alpha))
    u = np.array(jax.random.normal(key, (40, dim), jnp.float64))
    x, lq = tpf._sample_and_logq(_t(u), _t(mu), _t(alpha), b, g)
    q, ell, hld = tpf._sqrt_pieces(_t(alpha), b, g)
    got = (b, g, x, lq, hld, tpf._logq(_t(y), _t(mu), _t(alpha), q, ell, hld),
           tpf._alpha_update(_t(alpha), _t(s), _t(z)))
    for name, a, r in zip(("beta", "gamma", "x", "logq", "half_logdet", "logq(y)", "alpha"),
                          got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **TOL)
    h = np.diag(alpha)
    for i in range(j):
        si, zi = S[i][:, None], Z[i][:, None]
        rho = 1.0 / float((zi.T @ si).item())
        v = np.eye(dim) - rho * (si @ zi.T)
        h = v @ h @ v.T + rho * (si @ si.T)
    np.testing.assert_allclose(np.diag(alpha) + (b @ g @ b.T).numpy(), h, rtol=1e-9, atol=1e-9)
    gv = rng.standard_normal(dim)
    np.testing.assert_allclose(tpf._sigma_mv(_t(alpha), b, g, _t(gv)).numpy(), h @ gv,
                               rtol=1e-9, atol=1e-9)


def test_masked_pairs_are_inert(rng):
    """A masked slot leaves Sigma as if the pair never existed."""
    dim, j = 4, 3
    S, Z, _ = _history(rng, dim, j)
    alpha = torch.ones(dim, dtype=F64)
    S0, Z0 = S.copy(), Z.copy()
    S0[0] = Z0[0] = 0.0
    bm, gm = tpf._factors(_t(S0), _t(Z0), torch.tensor([False, True, True]), alpha)
    b2, g2 = tpf._factors(_t(S[1:]), _t(Z[1:]), torch.ones(2, dtype=torch.bool), alpha)
    np.testing.assert_allclose((bm @ gm @ bm.T).numpy(), (b2 @ g2 @ b2.T).numpy(),
                               rtol=1e-10, atol=1e-12)


def _pf_models():
    """A LogNormal scale and two Normal means (dim 3) with a likelihood."""
    jp = jd.NamedProduct.of(s=jd.LogNormal(0.0, 0.5), m=jd.Normal(0.0, 2.0), b=jd.Normal(0.0, 1.0))

    def lik(x, log):
        return (-0.5 * (1.2 - x["m"] - 0.5 * x["b"]) ** 2 / x["s"] ** 2 - log(x["s"])
                - 2.0 * (x["b"] - 0.3) ** 2)

    jm = JModel(priors=jp, loglik=lambda x: lik(x, jnp.log))
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jp), **CPU64), loglik=lambda x: lik(x, torch.log),
                   device="cpu")
    return jm, tm


def test_fit_pathfinder_matches_jax_on_its_draws(key):
    """A whole run given the JAX run's standard normals (its key split as
    fit_pathfinder splits it): every candidate's ELBO, the best index,
    the best candidate's factors, draws, log q and log p (1e-10; the
    L-BFGS iterates under them agree to about 1e-12). The start keeps the
    twelve iterates short of convergence: past it the pairs (s, z) are
    differences of values equal to a few ulps, which two orders of
    summation round differently."""
    jm, tm = _pf_models()
    L, M, N, dim = 12, 30, 50, 3
    v0 = np.array([3.0, 2.0, -2.0])  # the iterates stay short of convergence
    ref = jax.jit(lambda k, v: jfit_pathfinder(jm.batched_logdensity_fn(), k, v, max_iters=L,
                                               n_elbo_mc=M, n_draws=N))(key, jnp.asarray(v0))
    ke, kd = jax.random.split(key)
    u_c = jax.vmap(lambda k: jax.random.normal(k, (M, dim), jnp.float64))(jax.random.split(ke, L))
    draws = iter([_t(u_c), _t(jax.random.normal(kd, (N, dim), jnp.float64))])
    got = tpf._results(tm.logdensity_fn(), lambda shape: next(draws), _t(v0)[None], L, 6, M,
                       N, None)[0]
    np.testing.assert_allclose(got.elbo.numpy(), np.asarray(ref.elbo), **TOL)
    assert int(got.best) == int(ref.best)
    for name in ("position", "draws", "logq", "logp", "alpha", "beta", "gamma"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


def test_pathfinder_gaussian_target():
    """tests/test_pathfinder.py's correlated Gaussian: the best candidate
    sits at the mode with the target's covariance; it beats the first."""
    cov = torch.tensor([[1.0, 0.8], [0.8, 1.0]], dtype=F64)
    prec, mean = torch.linalg.inv(cov), torch.tensor([1.5, -0.5], dtype=F64)

    def logp(v):
        d = v - mean
        return -0.5 * torch.sum((d @ prec) * d, -1)

    logp.batch_capable = True
    res = fit_pathfinder(logp, torch.Generator().manual_seed(0),
                         torch.tensor([4.0, 4.0], dtype=F64), max_iters=15, n_draws=8000)
    np.testing.assert_allclose(res.position.numpy(), mean.numpy(), atol=5e-2)
    np.testing.assert_allclose(np.cov(res.draws.numpy().T), cov.numpy(), rtol=0.15, atol=0.08)
    assert float(res.elbo[res.best]) > float(res.elbo[0])


def test_multipath_conjugate_moments():
    """The Beta-Binomial through 4 paths and truncated importance
    resampling: moments within tests/test_pathfinder.py's bounds."""
    a, b, n, h = 2.0, 2.0, 50, 17
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jd.NamedProduct.of(p=jd.Beta(a, b))), **CPU64),
                   loglik=lambda x: h * torch.log(x["p"]) + (n - h) * torch.log1p(-x["p"]),
                   device="cpu")
    gen = torch.Generator().manual_seed(7)
    draws, res = multipath_pathfinder(tm.logdensity_fn(), gen, tm.init_positions(gen, 4, 2.0),
                                      n_draws=4000, per_path_draws=500, max_iters=15)
    p = tm.constrain(draws)["p"].numpy().ravel()
    ap, bp = a + h, b + n - h
    sd = np.sqrt(ap * bp / ((ap + bp) ** 2 * (ap + bp + 1)))
    np.testing.assert_allclose(p.mean(), ap / (ap + bp), atol=3 * sd / 10)
    np.testing.assert_allclose(p.std(), sd, rtol=0.35)
    assert res.draws.shape == (4, 500, 1) and res.elbo.shape == (4, 15)


# ---------------------------------------------------------------------------
# PSIS-LOO, WAIC, the GPD fit
# ---------------------------------------------------------------------------


def _conjugate_ll(rng, n_obs=24, n_draws=2000):
    """Pointwise log likelihood of exact posterior draws of a conjugate
    normal mean (tests/test_loo.py's model)."""
    y = 1.3 + rng.standard_normal(n_obs)
    v = 1.0 / (1.0 / 4.0 + n_obs)
    th = v * y.sum() + np.sqrt(v) * rng.standard_normal(n_draws)
    return -0.5 * (y[None, :] - th[:, None]) ** 2 - 0.5 * np.log(2 * np.pi)


def test_loo_waic_gpd_match_jax(rng):
    """fit_gpd on GPD and exponential samples (one and a batch of fits),
    psis_loo and waic on the same matrix (a heavy-tailed column too),
    the too-few-draws error."""
    u = rng.uniform(size=(2, 800))
    y = np.stack([1.5 / 0.3 * ((1 - u[0]) ** -0.3 - 1), rng.exponential(2.0, 800)])
    k, s = fit_gpd(_t(y))
    for i in range(2):
        jk, js = jax.jit(jfit_gpd)(jnp.asarray(y[i]))
        np.testing.assert_allclose([float(k[i]), float(s[i])], [float(jk), float(js)], **TOL)
    ll = _conjugate_ll(rng)
    ll[:, 3] += 4.0 * rng.standard_t(2, ll.shape[0])
    got, ref = psis_loo(_t(ll)), jax.jit(jpsis_loo)(jnp.asarray(ll))
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   err_msg=f, **TOL)
    got, ref = waic(_t(ll)), jax.jit(jwaic)(jnp.asarray(ll))
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   err_msg=f, **TOL)
    with pytest.raises(ValueError, match="too few draws"):
        psis_loo(torch.zeros((20, 5), dtype=F64))


# ---------------------------------------------------------------------------
# the evidence estimators
# ---------------------------------------------------------------------------


def _gaussian_models():
    """tests/test_evidence.py's Gaussian (dim 2), log Z analytic."""
    s0, y, s = np.array([1.0, 2.0]), np.array([1.0, -0.5]), 0.6
    jy, ty = jnp.asarray(y), torch.as_tensor(y)
    jp = jd.NamedProduct.of(x=jd.MvNormalDiag(jnp.zeros(2), jnp.asarray(s0)))
    jm = JModel(priors=jp, loglik=lambda t: jnp.sum(-0.5 * ((jy - t["x"]) / s) ** 2 - np.log(s)
                                                    - 0.5 * np.log(2 * np.pi)))
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jp), **CPU64),
                   loglik=lambda t: torch.sum(-0.5 * ((ty - t["x"]) / s) ** 2 - np.log(s)
                                              - 0.5 * np.log(2 * np.pi)), device="cpu")
    log_z = float(np.sum(-0.5 * y**2 / (s0**2 + s**2) - 0.5 * np.log(2 * np.pi * (s0**2 + s**2))))
    return jm, tm, log_z


def test_evidence_estimators_match_jax(key):
    """Both estimators on the JAX package's proposal draws, with a Laplace
    proposal (the port's fit, the same factor on both sides) and the ADVI
    Gaussians: log Z, ESS, Pareto k, the bridge's trace and error, 1e-10;
    the port's own runs land on the analytic evidence
    (tests/test_evidence.py's bounds)."""
    jm, tm, log_z = _gaussian_models()
    _, lap = map_laplace(tm, n_steps=60)
    jlap = JLaplaceApprox(*(jnp.asarray(t.numpy()) for t in lap))
    post = np.array(jlap.sample(jax.random.PRNGKey(1), 2000))
    mf = (JMeanField(jlap.mean + 0.2, jnp.log(jlap.marginal_sd() * 1.3)),
          MeanFieldGaussian(_t(jlap.mean) + 0.2, torch.log(lap.marginal_sd() * 1.3)))
    fr = (JFullRank(jlap.mean, jnp.diag(jnp.log(jlap.marginal_sd() * 1.5))),
          FullRankGaussian(_t(jlap.mean), torch.diag(torch.log(lap.marginal_sd() * 1.5))))
    jfn, blogp = jm.batched_logdensity_fn(), tm.logdensity_fn().batched_form
    for jq, q in ((jlap, lap), mf):
        ref = jax.jit(lambda k, q=jq: jis(jfn, q, k, n=1024))(key)
        got = tev._is_from_draws(blogp, q, _t(jq.sample(key, 1024)))
        for f in got._fields:
            np.testing.assert_allclose(float(getattr(got, f)), float(getattr(ref, f)),
                                       err_msg=f, **TOL)
    for jq, q in ((jlap, lap), fr):
        ref = jax.jit(lambda k, q=jq: jbridge(jfn, jnp.asarray(post), q, k, n_iters=32))(key)
        got = tev._bridge_from_draws(blogp, _t(post), q, _t(jq.sample(key, 2000)), 32)
        for f in got._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                       err_msg=f, **TOL)
    g = torch.Generator().manual_seed(3)
    res = bridge_sampling_evidence(tm.logdensity_fn(), _t(post), lap, g)
    np.testing.assert_allclose(float(res.log_evidence), log_z, atol=0.01)
    assert abs(float(res.trace[-1] - res.trace[-2])) < 1e-8 and float(res.rel_mc_error) < 0.05
    res = importance_sampling_evidence(tm.logdensity_fn(), mf[1], g, n=4096)
    np.testing.assert_allclose(float(res.log_evidence), log_z, atol=0.03)
    assert float(res.ess) > 1000.0 and float(res.pareto_k) < 0.7


# ---------------------------------------------------------------------------
# Model.sample(init='pathfinder')
# ---------------------------------------------------------------------------


def test_sample_init_pathfinder():
    """The starts are fit_pathfinder's draws from zeros and inv_mass0 the
    clipped diagonal of its Sigma, alpha + rowsum(beta * (beta gamma)),
    except for the dense metric; a user's inv_mass0 wins; the sampler runs
    from them."""
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jd.NamedProduct.of(
        mu=jd.Normal(0.5, 1.0), sigma=jd.LogNormal(0.0, 0.5))), **CPU64), device="cpu")
    res = fit_pathfinder(tm.logdensity_fn(), torch.Generator().manual_seed(2),
                         torch.zeros(tm.dim(), dtype=F64), n_draws=6)
    kw = {}
    q0 = tm._init(torch.Generator().manual_seed(2), 6, "pathfinder", kw)
    np.testing.assert_allclose(q0.numpy(), res.draws.numpy(), **TOL)
    diag = res.alpha + torch.sum(res.beta * (res.beta @ res.gamma), dim=1)
    np.testing.assert_allclose(kw["inv_mass0"].numpy(), diag.clamp(min=1e-10).numpy(), **TOL)
    sigma = torch.diag(res.alpha) + res.beta @ res.gamma @ res.beta.T
    np.testing.assert_allclose(kw["inv_mass0"].numpy(), torch.diagonal(sigma).numpy(), rtol=1e-9)
    kw = {"metric": "dense"}
    tm._init(torch.Generator().manual_seed(2), 6, "pathfinder", kw)
    assert "inv_mass0" not in kw
    raw, _, _ = tm.sample(torch.Generator().manual_seed(1), n_chains=6, n_warmup=10,
                          n_samples=5, kernel="nuts_batched", constrained=False,
                          init="pathfinder", max_depth=3)
    assert raw.shape == (5, 6, tm.dim()) and bool(torch.isfinite(raw).all())


# ---------------------------------------------------------------------------
# the script: the JAX package's float64 references of paths 23 and 24
# ---------------------------------------------------------------------------


def _w_means(m, draws):
    return np.asarray(m.constrain(draws)["w"]).reshape(-1, 16).mean(0)


def _pool_ess(res):
    """The effective size of multi-path's pooled draws under its truncated
    importance weights (what it resamples from)."""
    from scipy.special import logsumexp

    lw = np.asarray(res.logp - res.logq, dtype=np.float64).reshape(-1)
    lw = np.where(np.isfinite(lw), lw, -np.inf)
    n = lw.size
    lw = np.minimum(lw, logsumexp(lw) - np.log(n) + 0.5 * np.log(n))
    p = np.exp(lw - logsumexp(lw))
    return float(1.0 / np.sum(p * p))


def run_jax(seeds, dtype):
    """One JSON line a seed, then the references. In float32 (x64 off) only
    Pathfinder's, which are float32's own (chip_smoke.PATHFINDER_JAX_F32's
    comment)."""
    from test_torch_funnel import jax_model

    from tpu_bijectors.infer import multipath_pathfinder as jmultipath

    m, _ = jax_model()
    dim = 151
    fn = m.logdensity_fn()
    t0 = time.perf_counter()
    res, lap = jmap_laplace(m, n_steps=200)
    laplace = {"lp": float(res.logdensity), "grad_norm": float(res.grad_norm),
               "log_evidence": float(lap.log_evidence()),
               "position": [float(x) for x in np.asarray(res.position)],
               "seconds": time.perf_counter() - t0}
    print(json.dumps({"map_laplace": {k: v for k, v in laplace.items() if k != "position"}}),
          flush=True)
    is_run = jax.jit(lambda k: jis(m.batched_logdensity_fn(), lap, k, n=4096))
    pf = jax.jit(lambda k: jfit_pathfinder(fn, k, jnp.zeros(dim)))
    mp = jax.jit(lambda k: jmultipath(fn, k, 0.3 * jax.random.normal(jax.random.fold_in(k, 1),
                                                                     (8, dim))))
    lines = []
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        ev = is_run(key)
        r1 = pf(key)
        draws, r8 = mp(key)
        line = {"seed": seed, "is_log_evidence": float(ev.log_evidence), "is_ess": float(ev.ess),
                "is_pareto_k": float(ev.pareto_k),
                "single_elbo": float(r1.elbo[r1.best]), "single_best": int(r1.best),
                "single_w": _w_means(m, r1.draws).tolist(),
                "multi_elbo": float(jnp.max(jnp.take_along_axis(r8.elbo, r8.best[:, None], 1))),
                "multi_w": _w_means(m, draws).tolist(), "multi_ess": _pool_ess(r8),
                "w_sd": np.asarray(m.constrain(draws)["w"]).std(0).tolist()}
        lines.append(line)
        print(json.dumps(line), flush=True)

    def mean_spread(k):
        x = np.array([ln[k] for ln in lines])
        return [float(x.mean()), float(x.std(ddof=1))]

    def w_ref(k):
        x = np.array([ln[k] for ln in lines])  # (seeds, 16)
        sd = np.array([ln["w_sd"] for ln in lines]).mean(0)
        z = (x - x.mean(0)) / sd
        pooled = float(np.sqrt(np.sum(z**2) / (z.shape[1] * (z.shape[0] - 1))))
        out = {"mean": x.mean(0).tolist(), "sd": sd.tolist(), "spread_in_sd": pooled}
        if k == "multi_w":
            out["ess"] = [ln["multi_ess"] for ln in lines]
        return out

    pathfinder = {"single_elbo": mean_spread("single_elbo"),
                  "multi_elbo": mean_spread("multi_elbo"), "single_w": w_ref("single_w"),
                  "multi_w": w_ref("multi_w"), "seeds": list(seeds)}
    if dtype == "float32":
        print(json.dumps({"PATHFINDER_JAX_F32": pathfinder}), flush=True)
        return
    print(json.dumps({"LAPLACE_JAX": {**laplace, "is_log_evidence": mean_spread(
        "is_log_evidence")}}), flush=True)
    print(json.dumps({"PATHFINDER_JAX": pathfinder}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=["jax"], default="jax")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5, 6, 7])
    ap.add_argument("--dtype", choices=["float64", "float32"], default="float64")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    run_jax(args.seeds, args.dtype)


if __name__ == "__main__":
    main()
