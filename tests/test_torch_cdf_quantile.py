"""The port's cdfs, quantiles and CDF/Quantile bijectors against the JAX
package (tests/test_cdf_coverage.py and test_quantile_grad.py on the
ported families), in float64 on the CPU from the same numpy inputs:

- every ported scalar family's cdf and quantile (the closed forms, and the
  generic solve where a family has none) against the JAX family's, 1e-10;
- d quantile / dq against jax.grad and against 1 / pdf;
- the implicit-function rule's parameter gradients (Gamma-a, Beta-a,
  InverseGamma-scale, StudentT-df, and a Truncated's and a Mixture's
  inner parameters) against jax.grad and against central differences of
  the quantile. Where torch's cdf has no derivative in the
  parameter (gammainc's a, the port's betainc's a and b) the partial
  dcdf/dtheta is itself a central difference, as the JAX package takes for
  betainc, so those rows hold to 1e-8 against JAX (JAX differentiates
  gammainc in a exactly; both difference betainc);
- forward mode and a finite second derivative;
- coverage or a loud TypeError over the port's families;
- NUTS on a quantile-linked prior at the reference test's sizes.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from tpu_bijectors import dists as jd

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch.bijectors.cdf_quantile import has_cdf
from tpu_bijectors_torch.dists.base import Distribution, LeafDistribution, Support

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-10, atol=1e-10)
FD_PARTIAL_RTOL = 1e-8  # a central-difference dcdf/dtheta against JAX's
QS = np.asarray([0.001, 0.1, 0.35, 0.5, 0.8, 0.999])

# (family, parameters, closed-form quantile in the port)
FAMILIES = [
    ("Normal", (0.3, 1.7), True),
    ("StudentT", (4.0, 0.2, 1.1), False),
    ("Cauchy", (-0.5, 2.0), True),
    ("Laplace", (0.3, 1.7), True),
    ("Logistic", (0.1, 0.6), True),
    ("Gumbel", (0.2, 1.4), True),
    ("LogNormal", (0.2, 0.6), True),
    ("Exponential", (1.3,), True),
    ("Gamma", (2.0, 3.0), False),
    ("InverseGamma", (3.0, 0.5), False),
    ("Chi", (2.0,), False),
    ("Weibull", (1.7, 2.2), True),
    ("Rayleigh", (2.1,), True),
    ("Frechet", (2.5, 1.3), True),
    ("HalfNormal", (1.4,), True),
    ("HalfCauchy", (0.8,), True),
    ("Beta", (2.0, 5.0), False),
    ("LogitNormal", (0.2, 1.1), True),
    ("Uniform", (-1.0, 2.5), True),
    ("Pareto", (2.5, 1.5), True),
    ("Levy", (0.5, 2.0), True),
    ("Kumaraswamy", (2.0, 3.0), True),
    ("Arcsine", (-1.0, 2.0), True),
    ("BetaPrime", (2.0, 3.0), False),
    ("InverseGaussian", (1.0, 2.0), False),
    ("TriangularDist", (-1.0, 3.0, 0.5), True),
    ("JohnsonSU", (0.1, 1.2, 0.4, 1.5), True),
]


def _pair(name, params):
    return getattr(jd, name)(*params), getattr(td, name)(*params, **F64)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _beyond(x):
    """The quantiles and a point past each end of the support."""
    return jnp.concatenate([x, x[jnp.asarray([0, -1])] + jnp.asarray([-1.0, 1.0])])


def _jax_rows(jdist):
    """The JAX family's quantiles at QS, its cdf at `_beyond` them and d
    quantile / dq, in one compiled call."""

    def rows(q):
        x = jdist.quantile(q)
        return x, jdist.cdf(_beyond(x)), jax.vmap(jax.grad(jdist.quantile))(q)

    return jax.jit(rows)(jnp.asarray(QS))


@pytest.mark.parametrize("name,params,closed", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_cdf_and_quantile_against_jax(name, params, closed):
    jdist, tdist = _pair(name, params)
    assert has_cdf(tdist)
    assert ("quantile" in vars(type(tdist))) == closed
    xj, cdfj, gj = _jax_rows(jdist)
    q = torch.as_tensor(QS).requires_grad_(True)
    xt = tdist.quantile(q)
    np.testing.assert_allclose(_np(xt), np.asarray(xj), **TOL)
    np.testing.assert_allclose(_np(tdist.cdf(xt)), QS, atol=1e-9)
    # the cdf on the JAX quantiles and on points beyond the support's ends
    np.testing.assert_allclose(_np(tdist.cdf(torch.as_tensor(_beyond(np.asarray(xj))))),
                               np.asarray(cdfj), **TOL)
    # d quantile / dq against jax.grad and 1 / pdf (the tails' pdf is small:
    # relative tolerance)
    (g,) = torch.autograd.grad(xt.sum(), q)
    np.testing.assert_allclose(_np(g)[1:-1], np.asarray(gj)[1:-1], rtol=1e-9)
    np.testing.assert_allclose(_np(g)[1:-1], 1.0 / np.exp(_np(tdist.logpdf(xt[1:-1]))), rtol=1e-9)
    assert np.all(_np(g) > 0)


PARAM_CASES = [
    ("Gamma-a", lambda a, m: m.Gamma(a, 3.0, **_kw(m)), 2.0, True),
    ("Beta-a", lambda a, m: m.Beta(a, 5.0, **_kw(m)), 2.0, True),
    ("InverseGamma-scale", lambda s, m: m.InverseGamma(3.0, s, **_kw(m)), 0.5, False),
    ("StudentT-df", lambda v, m: m.StudentT(v, **_kw(m)), 4.0, True),
]


def _kw(m):
    return F64 if m is td else {}


@pytest.mark.parametrize("name,make,theta,fd_partial", PARAM_CASES, ids=[c[0] for c in PARAM_CASES])
def test_quantile_parameter_gradient(name, make, theta, fd_partial):
    """d quantile(0.3) / d theta by the implicit-function rule, reverse and
    forward mode, against jax.grad and central differences of the
    quantile (the reference test's eps 1e-6 and rtol 1e-6)."""
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(make(t, td).quantile(0.3), t)
    gj = float(jax.jit(jax.grad(lambda a: make(a, jd).quantile(0.3)))(theta))
    np.testing.assert_allclose(float(g), gj, rtol=FD_PARTIAL_RTOL if fd_partial else 1e-10)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(make(torch.tensor(theta + eps, dtype=torch.float64), td).quantile(0.3))
              - float(make(torch.tensor(theta - eps, dtype=torch.float64), td).quantile(0.3))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-6)
    assert float(g) != 0.0
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(theta, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
        tangent = fwAD.unpack_dual(make(dual, td).quantile(0.3)).tangent
    np.testing.assert_allclose(float(tangent), float(g), rtol=1e-12)


WRAPPER_CASES = [  # name, make, theta, fd_partial, second derivative against JAX's
    ("Truncated-Normal-mu", lambda t, m: m.Truncated(m.Normal(t, 1.3, **_kw(m)), 0.2, 1.5), 0.4, False, True),
    ("Truncated-Normal-scale", lambda s, m: m.Truncated(m.Normal(0.4, s, **_kw(m)), 0.2, 1.5), 1.3, False, False),
    ("Truncated-below-Normal-mu", lambda t, m: m.Truncated(m.Normal(t, 1.3, **_kw(m)), lower=-0.5), 0.4, False, False),
    ("Truncated-Gamma-a", lambda a, m: m.Truncated(m.Gamma(a, 3.0, **_kw(m)), 0.2, 1.5), 2.0, True, False),
]


@pytest.mark.parametrize("name,make,theta,fd_partial,second", WRAPPER_CASES,
                         ids=[c[0] for c in WRAPPER_CASES])
def test_wrapper_quantile_parameter_gradient(name, make, theta, fd_partial, second):
    """The generic quantile of a Truncated differentiates its base's
    parameters, as the JAX package's pytree flattening does: the value,
    jax.grad, forward mode and (on one case) jax.grad of jax.grad."""
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    x = make(t, td).quantile(0.3)
    f = lambda a: make(a, jd).quantile(0.3)
    xj, gj = jax.jit(jax.value_and_grad(f))(theta)
    np.testing.assert_allclose(float(x.detach()), float(xj), rtol=1e-10)
    (g,) = torch.autograd.grad(x, t, create_graph=second)
    np.testing.assert_allclose(float(g), float(gj), rtol=FD_PARTIAL_RTOL if fd_partial else 1e-10)
    assert float(g) != 0.0
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(theta, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
        tangent = fwAD.unpack_dual(make(dual, td).quantile(0.3)).tangent
    np.testing.assert_allclose(float(tangent), float(g), rtol=1e-12)
    if second:
        (h,) = torch.autograd.grad(g, t)
        np.testing.assert_allclose(float(h), float(jax.jit(jax.grad(jax.grad(f)))(theta)), rtol=1e-9)


def test_mixture_quantile_gradient():
    """A Mixture's leaves act on every x (each x sees all K components):
    d quantile / d loc and d / d log_weights against jax.grad, and a jvp in
    loc against jax.jvp."""
    loc, sc, lw = np.array([-1.0, 2.0]), np.array([1.0, 1.5]), np.log(np.array([0.3, 0.7]))
    qs = np.array([0.1, 0.5, 0.9])
    tl, tlw = torch.tensor(loc, requires_grad=True), torch.tensor(lw, requires_grad=True)
    x = td.Mixture(td.Normal(tl, torch.tensor(sc), **F64), tlw).quantile(torch.tensor(qs))
    gl, glw = torch.autograd.grad(x.sum(), (tl, tlw))
    fj = lambda l, w: jd.Mixture(jd.Normal(l, jnp.asarray(sc)), w).quantile(jnp.asarray(qs))
    gjl, gjw = jax.jit(jax.grad(lambda l, w: fj(l, w).sum(), (0, 1)))(jnp.asarray(loc), jnp.asarray(lw))
    np.testing.assert_allclose(_np(x), np.asarray(jax.jit(fj)(jnp.asarray(loc), jnp.asarray(lw))), rtol=1e-10)
    np.testing.assert_allclose(_np(gl), np.asarray(gjl), rtol=1e-10)
    np.testing.assert_allclose(_np(glw), np.asarray(gjw), rtol=1e-10)
    e0 = np.array([1.0, 0.0])
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(loc), torch.tensor(e0))
        q = torch.tensor(qs)
        tangent = fwAD.unpack_dual(td.Mixture(td.Normal(dual, torch.tensor(sc), **F64), torch.tensor(lw)).quantile(q)).tangent
    _, tj = jax.jit(lambda l, t: jax.jvp(lambda v: fj(v, jnp.asarray(lw)), (l,), (t,)))(
        jnp.asarray(loc), jnp.asarray(e0))
    np.testing.assert_allclose(_np(tangent), np.asarray(tj), rtol=1e-10)
    # a central-difference partial is elementwise, which a mixture's
    # components are not: loud, not a wrong derivative
    ta = torch.tensor([2.0, 3.0], dtype=torch.float64, requires_grad=True)
    xg = td.Mixture(td.Gamma(ta, torch.tensor([3.0, 1.0]), **F64), torch.tensor(lw)).quantile(torch.tensor(qs))
    with pytest.raises(NotImplementedError, match="mixes its leaves"):
        torch.autograd.grad(xg.sum(), ta)


def test_quantile_second_order_and_forward_mode():
    d, dj = td.Gamma(2.0, 3.0, **F64), jd.Gamma(2.0, 3.0)
    q = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(d.quantile(q), q, create_graph=True)
    (h,) = torch.autograd.grad(g, q)
    hj = float(jax.jit(jax.grad(jax.grad(dj.quantile)))(0.3))
    assert np.isfinite(float(h))
    np.testing.assert_allclose(float(h), hj, rtol=1e-9)
    b = tbt.QuantileBijector(d)
    qs = torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64, requires_grad=True)
    (gq,) = torch.autograd.grad(b.forward(qs).sum(), qs)
    assert torch.all(torch.isfinite(gq))
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(0.3, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
        tangent = fwAD.unpack_dual(b.forward(dual)).tangent
    x = b.forward(torch.tensor(0.3, dtype=torch.float64))
    np.testing.assert_allclose(float(tangent), float(1.0 / torch.exp(d.logpdf(x))), rtol=1e-10)
    # the inverse of a CDFBijector is the same quantile
    (gi,) = torch.autograd.grad(tbt.CDFBijector(d).inverse(q), q)
    np.testing.assert_allclose(float(gi), float(1.0 / torch.exp(d.logpdf(x))), rtol=1e-10)


def test_quantile_bijectors_against_jax():
    d, dj = td.Gamma(2.0, 3.0, **F64), jd.Gamma(2.0, 3.0)
    q = torch.as_tensor(QS)
    y, ld = tbt.QuantileBijector(d).forward_and_log_det(q)
    yj, ldj = jax.jit(jd_bij(dj).forward_and_log_det)(jnp.asarray(QS))
    np.testing.assert_allclose(_np(y), np.asarray(yj), **TOL)
    np.testing.assert_allclose(_np(ld), np.asarray(ldj), **TOL)
    u, ldu = tbt.CDFBijector(d).forward_and_log_det(y)
    np.testing.assert_allclose(_np(u), QS, atol=1e-12)
    np.testing.assert_allclose(_np(ldu), -_np(ld), rtol=1e-12)
    assert tbt.inverse(tbt.QuantileBijector(d)) == tbt.CDFBijector(d)
    assert tbt.inverse(tbt.CDFBijector(d)) == tbt.QuantileBijector(d)
    assert tbt.CDFBijector(d).monotonically_increasing


def jd_bij(dj):
    from tpu_bijectors.bijectors.cdf_quantile import QuantileBijector

    return QuantileBijector(dj)


# the continuous families with no cdf in the JAX package either
KNOWN_NO_CDF = {"SkewNormal", "VonMises", "Rician", "NoncentralChisq", "NoncentralBeta",
                "NoncentralF", "NoncentralT", "NormalInverseGaussian", "SkewedExponentialPower",
                "StudentizedRange"}


def _scalar_instances():
    """One default instance of each of the port's continuous scalar leaf
    families."""
    out = []
    for name in sorted(dir(td)):
        cls = getattr(td, name)
        if not (inspect.isclass(cls) and issubclass(cls, LeafDistribution)) or cls is LeafDistribution:
            continue
        try:
            d = cls(**F64)
        except TypeError:
            continue  # a family without defaults (the vector ones)
        if d.event_ndims == 0 and d.support.kind != "discrete":
            out.append((name, d))
    return out


def test_every_family_covered_or_loud():
    instances = _scalar_instances()
    assert len(instances) >= 27
    silent = []
    for name, d in instances:
        if has_cdf(d):
            b = tbt.CDFBijector(d)
            x = d.sample(torch.Generator().manual_seed(7), (5,))
            u, ld = b.forward_and_log_det(x)
            assert bool(((u >= 0) & (u <= 1)).all()), name
            np.testing.assert_allclose(_np(ld), _np(d.logpdf(x)), rtol=1e-9, err_msg=name)
            np.testing.assert_allclose(_np(b.inverse(u)), _np(x), rtol=2e-5, atol=2e-5, err_msg=name)
        elif name in KNOWN_NO_CDF:
            for B in (tbt.CDFBijector, tbt.QuantileBijector):
                with pytest.raises(TypeError):
                    B(d)
        else:
            silent.append(name)
    assert not silent, f"families lacking a cdf outside the documented list: {silent}"


class _Discrete(Distribution):
    @property
    def support(self):
        return Support("discrete")

    def cdf(self, x):
        return torch.floor(x)


def test_rejects_discrete_vector_and_cdfless():
    with pytest.raises(TypeError):
        tbt.CDFBijector(_Discrete())
    with pytest.raises(TypeError):
        tbt.CDFBijector(td.Dirichlet(np.ones(3), **F64))
    with pytest.raises(TypeError):
        tbt.QuantileBijector(td.SkewNormal(**F64))


def test_truncated_sample_through_the_quantile():
    """Truncated.sample inverts its base's cdf through `quantile` (closed
    form or the generic solve): draws inside the bounds, their cdf uniform."""
    for base in (td.Normal(0.3, 1.2, **F64), td.Gamma(2.0, 3.0, **F64)):
        t = td.Truncated(base, lower=0.2, upper=1.5)
        x = t.sample(torch.Generator().manual_seed(3), (4000,))
        assert bool(((x >= 0.2) & (x <= 1.5)).all())
        u = np.sort(_np(t.cdf(x)))
        assert np.abs(u - (np.arange(4000) + 0.5) / 4000).max() < 0.03


def test_quantile_linked_prior_nuts_mixes():
    """NUTS over a prior transformed through QuantileBijector(Gamma(2, 3))
    (rate 3: mean 2/3, sd sqrt(2)/3) at the reference test's sizes, with
    kernel='auto' on the CPU: the draws' mean within 5 MCSE of the exact
    one and their sd moving off the start."""
    theta = tbt.transformed(td.Uniform(0.0, 1.0, **F64), tbt.QuantileBijector(td.Gamma(2.0, 3.0, **F64)))
    model = tbt.Model(td.NamedProduct.of(theta=theta), device="cpu")
    assert model._auto_kernel() == "nuts_batched_t"
    samples, _, _ = model.sample(torch.Generator().manual_seed(0), n_chains=4, n_warmup=200,
                                 n_samples=300)
    th = _np(samples["theta"]).reshape(-1)
    assert np.all(np.isfinite(th)) and np.all(th > 0)
    mean, sd = 2.0 / 3.0, np.sqrt(2.0) / 3.0
    # 1200 draws, autocorrelated: an effective size of 200 as the reference
    assert abs(th.mean() - mean) < 5.0 * sd / np.sqrt(200.0)
    assert th.std() > 0.25 * sd
