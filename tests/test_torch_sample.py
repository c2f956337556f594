"""Every ported family's `sample` in distribution.

The port's draws cannot match the JAX package's draw for draw (another
generator), so each family is built from the JAX package's parameters
(`dist_from_spec`) and its seeded float64 draws on the CPU are held to
the exact distribution: the shape sample_shape + batch_shape +
event_shape, the support (`in_support`), and a Kolmogorov-Smirnov test
against scipy's cdf (p > 1e-3), or, where no cdf is at hand, the means
within 5 Monte Carlo standard errors of their exact values.
`sample_and_logpdf` is held to `logpdf` of its draw.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from scipy.special import expit, logit
from test_torch_fused import CPU64
from test_torch_vectorize_api import port_spec

import tpu_bijectors as tb
from tpu_bijectors import dists as jd

import tpu_bijectors_torch as tbt

N = 4000
P_MIN = 1e-3


def _port(jdist):
    return tbt.dist_from_spec(port_spec(jdist), **CPU64)


def _draw(d, seed, shape=(N,)):
    return d.sample(torch.Generator().manual_seed(seed), shape)


def _ks(x, cdf, what=""):
    p = st.kstest(np.asarray(x).ravel(), cdf).pvalue
    assert p > P_MIN, f"KS p = {p:.2e} {what}"


def _mean_within(x, exact, what=""):
    """The means over the draw axis 0 within 5 MCSE of `exact`."""
    x = np.asarray(x)
    se = x.std(0) / np.sqrt(x.shape[0])
    assert np.all(np.abs(x.mean(0) - exact) <= 5 * se + 1e-12), (what, x.mean(0), exact)


def _lognormal(mu, sigma):
    return st.lognorm(sigma, scale=np.exp(mu))


# (JAX family, scipy frozen distribution or cdf), parameters from the
# JAX family's own
SCALAR = {
    "Normal": (lambda: jd.Normal(0.5, 2.0), st.norm(0.5, 2.0)),
    "StudentT": (lambda: jd.StudentT(4.5, 0.3, 1.7), st.t(4.5, 0.3, 1.7)),
    "Cauchy": (lambda: jd.Cauchy(-0.4, 0.9), st.cauchy(-0.4, 0.9)),
    "Laplace": (lambda: jd.Laplace(0.2, 1.3), st.laplace(0.2, 1.3)),
    "Logistic": (lambda: jd.Logistic(0.1, 0.8), st.logistic(0.1, 0.8)),
    "Gumbel": (lambda: jd.Gumbel(-0.3, 1.1), st.gumbel_r(-0.3, 1.1)),
    "SkewNormal": (lambda: jd.SkewNormal(0.2, 1.3, -1.0), st.skewnorm(-1.0, 0.2, 1.3)),
    "LogNormal": (lambda: jd.LogNormal(0.2, 0.5), _lognormal(0.2, 0.5)),
    "Exponential": (lambda: jd.Exponential(0.8), st.expon(scale=1 / 0.8)),
    "Gamma": (lambda: jd.Gamma(2.0, 1.5), st.gamma(2.0, scale=1 / 1.5)),
    "Gamma_small": (lambda: jd.Gamma(0.4, 1.0), st.gamma(0.4)),
    "InverseGamma": (lambda: jd.InverseGamma(3.0, 2.0), st.invgamma(3.0, scale=2.0)),
    "Chi": (lambda: jd.Chi(3.0), st.chi(3.0)),
    "Weibull": (lambda: jd.Weibull(1.8, 2.1), st.weibull_min(1.8, scale=2.1)),
    "Rayleigh": (lambda: jd.Rayleigh(1.2), st.rayleigh(scale=1.2)),
    "Frechet": (lambda: jd.Frechet(2.3, 1.4), st.invweibull(2.3, scale=1.4)),
    "HalfNormal": (lambda: jd.HalfNormal(1.4), st.halfnorm(scale=1.4)),
    "HalfCauchy": (lambda: jd.HalfCauchy(0.7), st.halfcauchy(scale=0.7)),
    "Beta": (lambda: jd.Beta(2.5, 1.6), st.beta(2.5, 1.6)),
    "LogitNormal": (lambda: jd.LogitNormal(0.2, 0.9),
                    lambda x: st.norm.cdf((logit(x) - 0.2) / 0.9)),
    "Uniform": (lambda: jd.Uniform(-2.0, 5.0), st.uniform(-2.0, 7.0)),
    "Pareto": (lambda: jd.Pareto(2.2, 1.5), st.pareto(2.2, scale=1.5)),
    "Levy": (lambda: jd.Levy(0.4, 1.3), st.levy(0.4, 1.3)),
    "Kumaraswamy": (lambda: jd.Kumaraswamy(2.0, 5.0), lambda x: 1 - (1 - x**2.0) ** 5.0),
    "Arcsine": (lambda: jd.Arcsine(-1.0, 2.0), st.arcsine(-1.0, 3.0)),
    "BetaPrime": (lambda: jd.BetaPrime(1.5, 2.5), st.betaprime(1.5, 2.5)),
    "InverseGaussian": (lambda: jd.InverseGaussian(1.2, 2.0), st.invgauss(1.2 / 2.0, scale=2.0)),
    "TriangularDist": (lambda: jd.TriangularDist(0.0, 1.5, 0.5), st.triang(1 / 3, 0.0, 1.5)),
    "JohnsonSU": (lambda: jd.JohnsonSU(0.1, 1.2, 0.3, 1.5), st.johnsonsu(0.3, 1.5, 0.1, 1.2)),
    "Truncated": (lambda: jd.Truncated(jd.Normal(0.0, 1.0), lower=-0.5, upper=2.0),
                  st.truncnorm(-0.5, 2.0)),
    "Truncated_lower": (lambda: jd.Truncated(jd.Normal(0.3, 1.2), lower=0.0),
                        st.truncnorm(-0.25, np.inf, 0.3, 1.2)),
    "Mixture": (lambda: jd.Mixture(jd.Normal(jnp.asarray([-2.0, 0.0, 3.0]), jnp.asarray([1.2, 1.0, 2.5])),
                                   jnp.log(jnp.asarray([0.2, 0.5, 0.3]))),
                lambda x: (0.2 * st.norm.cdf(x, -2.0, 1.2) + 0.5 * st.norm.cdf(x, 0.0, 1.0)
                           + 0.3 * st.norm.cdf(x, 3.0, 2.5))),
}


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_family_sample(name):
    build, ref = SCALAR[name]
    d = _port(build())
    x = _draw(d, 11)
    assert x.shape == (N,) and x.dtype == torch.float64
    assert bool(d.in_support(x).all())
    _ks(x.numpy(), ref.cdf if hasattr(ref, "cdf") else ref, name)
    # sample_and_logpdf: the draw's own logpdf
    xs, lp = d.sample_and_logpdf(torch.Generator().manual_seed(3), (5, 2))
    assert xs.shape == (5, 2)
    np.testing.assert_allclose(lp.numpy(), d.logpdf(xs).numpy(), rtol=1e-12)


def _mv_cases():
    L = np.asarray([[2.0, 0.0, 0.0], [0.3, 1.5, 0.0], [-0.4, 0.2, 0.8]])
    J = np.asarray([[4.0, -2.0, -1.0], [-2.0, 5.0, -1.0], [-1.0, -1.0, 6.0]])
    loc = np.asarray([0.5, -1.0, 0.2])
    return {
        "MvNormalDiag": (jd.MvNormalDiag(jnp.asarray(loc), jnp.asarray([0.5, 1.0, 2.0])),
                         lambda x: [(x[:, i], st.norm(loc[i], s).cdf)
                                    for i, s in enumerate((0.5, 1.0, 2.0))]),
        "MvNormalTril": (jd.MvNormalTril(jnp.asarray(loc), jnp.asarray(L)),
                         lambda x: [(x[:, i], st.norm(loc[i], np.sqrt((L @ L.T)[i, i])).cdf)
                                    for i in range(3)] + [(x[:, 0] - x[:, 1], st.norm(
                                        loc[0] - loc[1], np.sqrt(np.asarray([1, -1, 0]) @ L @ L.T
                                                                 @ np.asarray([1, -1, 0]))).cdf)]),
        "MvLogNormal": (jd.MvLogNormal(jnp.asarray(loc), jnp.asarray([0.5, 1.0, 0.3])),
                        lambda x: [(np.log(x[:, i]), st.norm(loc[i], s).cdf)
                                   for i, s in enumerate((0.5, 1.0, 0.3))]),
        "MvStudentT": (jd.MvStudentT(4.0, jnp.asarray(loc), jnp.asarray(L)),
                       lambda x: [(x[:, i], st.t(4.0, loc[i], np.sqrt((L @ L.T)[i, i])).cdf)
                                  for i in range(3)]),
        "MvNormalCanon": (jd.MvNormalCanon(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray(J)),
                          lambda x: [(x[:, i], st.norm(np.linalg.solve(J, [1.0, 2.0, 3.0])[i],
                                                       np.sqrt(np.linalg.inv(J)[i, i])).cdf)
                                     for i in range(3)]),
        "JointOrderStatistics": (jd.JointOrderStatistics(jd.Normal(), 4),
                                 lambda x: [(x[:, 0], lambda t: 1 - (1 - st.norm.cdf(t)) ** 4),
                                            (x[:, 3], lambda t: st.norm.cdf(t) ** 4)]),
    }


MV = _mv_cases()


@pytest.mark.parametrize("name", sorted(MV))
def test_multivariate_family_sample(name):
    jdist, marginals = MV[name]
    d = _port(jdist)
    x = _draw(d, 12)
    assert x.shape == (N,) + tuple(d.event_shape)
    assert bool(d.in_support(x).all())
    if name == "JointOrderStatistics":
        assert bool((x[:, 1:] >= x[:, :-1]).all())
    for i, (xi, cdf) in enumerate(marginals(x.numpy())):
        _ks(xi, cdf, f"{name} marginal {i}")


def test_dirichlet_sample():
    a = np.asarray([1.3, 2.0, 0.8, 1.1])
    d = _port(jd.Dirichlet(jnp.asarray(a)))
    x = _draw(d, 13).numpy()
    assert x.shape == (N, 4) and np.all(x > 0)
    np.testing.assert_allclose(x.sum(-1), 1.0, atol=1e-12)
    for k in range(4):  # each coordinate is Beta(a_k, a_0 - a_k)
        _ks(x[:, k], st.beta(a[k], a.sum() - a[k]).cdf, f"Dirichlet coordinate {k}")
    _mean_within(x, a / a.sum())


@pytest.mark.parametrize("name", ["LKJ", "LKJCholesky_L", "LKJCholesky_U"])
def test_lkj_sample(name):
    """An off-diagonal r of LKJ(K, eta) has (r + 1)/2 ~ Beta(eta - 1 +
    K/2, eta - 1 + K/2), variance 1/(2 eta + K - 1)."""
    K, eta = (4, 2.0) if name == "LKJ" else (3, 1.5)
    jdist = jd.LKJ(K, eta) if name == "LKJ" else jd.LKJCholesky(K, eta, name[-1])
    d = _port(jdist)
    x = _draw(d, 14)
    assert x.shape == (N, K, K) and bool(d.in_support(x).all())
    if name == "LKJ":
        R = x
    else:
        tri = torch.tril(x) if name.endswith("L") else torch.triu(x)
        assert torch.equal(tri, x)
        R = x @ x.mT if name.endswith("L") else x.mT @ x
    np.testing.assert_allclose(torch.diagonal(R, dim1=-2, dim2=-1).numpy(), 1.0, atol=1e-12)
    b = eta - 1 + K / 2
    for i, j in ((0, 1), (K - 2, K - 1)):
        _ks((R[:, i, j].numpy() + 1) / 2, st.beta(b, b).cdf, f"{name} r[{i},{j}]")
    r = R[:, 0, 1].numpy()
    _mean_within(r * r, 1.0 / (2 * eta + K - 1), "off-diagonal variance")


@pytest.mark.parametrize("family", ["Wishart", "InverseWishart"])
def test_pd_family_sample(family):
    S = np.asarray([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])
    df, K = 7.0, 3
    d = _port(getattr(jd, family)(df, jnp.asarray(S)))
    x = _draw(d, 15)
    assert x.shape == (N, K, K) and bool(d.in_support(x).all())
    exact = df * S if family == "Wishart" else S / (df - K - 1)
    _mean_within(x.numpy().reshape(N, -1), exact.ravel(), family)


def test_products_and_transformed_sample():
    """IIDProduct, arraydist, Product, NamedProduct and transformed
    distributions: shapes, the structure of a draw, and KS tests of their
    parts."""
    g = _port(jd.IIDProduct(jd.Gamma(2.0, 3.0), 5))
    x = _draw(g, 16)
    assert x.shape == (N, 5)
    _ks(x.numpy(), st.gamma(2.0, scale=1 / 3.0).cdf, "IIDProduct")
    locs, scales = np.asarray([-1.0, 0.0, 2.0]), np.asarray([0.5, 1.0, 2.0])
    e = _port(jd.arraydist(jd.Normal(jnp.asarray(locs), jnp.asarray(scales))))
    x = _draw(e, 17)
    assert x.shape == (N, 3)
    _ks(((x.numpy() - locs) / scales), st.norm.cdf, "arraydist")
    p = _port(jd.Product((jd.LogNormal(), jd.Beta(2.0, 2.0), jd.Dirichlet(jnp.ones(3)))))
    x = _draw(p, 18)
    assert isinstance(x, tuple) and [t.shape for t in x] == [(N,), (N,), (N, 3)]
    _ks(x[1].numpy(), st.beta(2.0, 2.0).cdf, "Product's Beta")
    n = _port(jd.NamedProduct.of(a=jd.IIDProduct(jd.Normal(), 2), b=jd.Product((jd.Exponential(2.0),))))
    x = _draw(n, 19)
    assert set(x) == {"a", "b"} and x["a"].shape == (N, 2) and x["b"][0].shape == (N,)
    _ks(x["b"][0].numpy(), st.expon(scale=0.5).cdf, "NamedProduct's Exponential")
    for base, ref, inv in ((jd.LogNormal(0.2, 0.5), st.norm(0.2, 0.5).cdf, lambda y: y),
                           (jd.Beta(2.0, 3.0), st.beta(2.0, 3.0).cdf, expit)):
        td = _port(tb.transformed(base))
        y = _draw(td, 20)
        assert y.shape == (N,)
        _ks(inv(y.numpy()), ref, "transformed")
        ys, lp = td.sample_and_logpdf(torch.Generator().manual_seed(4), (6,))
        np.testing.assert_allclose(lp.numpy(), td.logpdf(ys).numpy(), rtol=1e-10)
