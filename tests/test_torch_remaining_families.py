"""The remaining continuous families, the wrappers and the matrix
families of the port against the JAX package, float64 on the CPU.

Every class of the seventeenth slice that has a density (the scalar
families of `dists/univariate.py`, `univariate2.py` and `univariate3.py`,
`affine.py`, `wrappers.py`, MvLogitNormal, MatrixBeta and MatrixTDist),
with the parameters of the JAX package's own tests
(`tests/test_all_matrix.py`, `test_wrappers.py`): logpdf at points of
the support within 1e-10, its gradient in x and in every tensor leaf
against `jax.grad` within 1e-9; the cdf within 1e-10 and the quantile
(closed form, or the generic solve) within 1e-9 with its implicit
derivative in q and in the leaves against `jax.grad` (1e-8; 1e-5 in a
leaf whose cdf derivative the port takes by central differences, gammainc's
a and betainc's a and b, where the JAX package has gammainc's analytic one
or its own central differences: their steps round differently); the
registry link and the linked density through `unconstrain` (and a served
leaf's traced tape, value and gradient, within 1e-10); the port's
draws against their law by scipy's Kolmogorov-Smirnov test
(`test_draws_in_distribution`); `testing.test_all` on each;
`dist_from_spec` on every wrapper's spec.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from test_torch_fused import CPU64, spec_of

from tpu_bijectors import dists as jd
from tpu_bijectors.registry import bijector as jbijector
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.dists.base import _tensor_leaves, _with_leaves
from tpu_bijectors_torch.testing import test_all
from tpu_bijectors_torch.vectorize import fused_plan as fp
from tpu_bijectors_torch.vectorize import fused_traced as ft

e = jnp.asarray
VAL = dict(rtol=1e-10, atol=1e-10)
DER = dict(rtol=1e-9, atol=1e-9)
QDER = dict(rtol=1e-8, atol=1e-8)
# a served leaf's tape against the JAX package's composed linked density
TAPE = dict(rtol=1e-10, atol=1e-10)
# a partial the port takes by central differences (module docstring)
QDER_FD = dict(rtol=1e-5, atol=1e-5)

# the continuous families and wrappers, with the JAX tests' parameters
FAMILIES = {
    "Chisq": lambda: jd.Chisq(3.0),
    "FDist": lambda: jd.FDist(10.0, 1.0),
    "VonMises": lambda: jd.VonMises(0.5, 2.0),
    "Semicircle": lambda: jd.Semicircle(1.0),
    "Cosine": lambda: jd.Cosine(0.0, 1.0),
    "Epanechnikov": lambda: jd.Epanechnikov(0.0, 1.0),
    "GeneralizedPareto": lambda: jd.GeneralizedPareto(0.0, 1.0, 1.0),
    "GeneralizedExtremeValue": lambda: jd.GeneralizedExtremeValue(0.0, 1.0, 1.0),
    "Gompertz": lambda: jd.Gompertz(1.0, 1.0),
    "Erlang": lambda: jd.Erlang(7.0, 0.5),
    "LogUniform": lambda: jd.LogUniform(1.0, 10.0),
    "NormalCanon": lambda: jd.NormalCanon(0.5, 2.0),
    "Biweight": lambda: jd.Biweight(1.0, 2.0),
    "Triweight": lambda: jd.Triweight(1.0, 1.0),
    "SymTriangularDist": lambda: jd.SymTriangularDist(0.0, 1.0),
    "PGeneralizedGaussian": lambda: jd.PGeneralizedGaussian(1.5, 0.2, 1.3),
    "Rician": lambda: jd.Rician(0.5, 1.0),
    "Lindley": lambda: jd.Lindley(1.5),
    "Kolmogorov": lambda: jd.Kolmogorov(),
    "NoncentralChisq": lambda: jd.NoncentralChisq(2.0, 3.0),
    "NoncentralBeta": lambda: jd.NoncentralBeta(2.0, 3.0, 1.0),
    "NoncentralF": lambda: jd.NoncentralF(2.0, 3.0, 1.0),
    "NoncentralT": lambda: jd.NoncentralT(2.0, 3.0),
    "NormalInverseGaussian": lambda: jd.NormalInverseGaussian(0.0, 0.5, 0.2, 0.1),
    "SkewedExponentialPower": lambda: jd.SkewedExponentialPower(0.0, 1.0, 0.7, 0.7),
    "StudentizedRange": lambda: jd.StudentizedRange(2.0, 2.0),
    "KSOneSided": lambda: jd.KSOneSided(10),
    "Affine_Gamma": lambda: jd.Gamma(2.0, 1.0 / 3.0) * -3,
    "Affine_Beta": lambda: jd.Beta(2.0, 5.0) + 2,
    "Affine_Logistic": lambda: jd.Logistic() * 3,
    "Censored": lambda: jd.Censored(jd.Normal(0.0, 1.0), lower=-1.0, upper=1.0),
    "Censored_lower": lambda: jd.Censored(jd.Normal(0.3, 1.2), lower=0.0),
    "OrderStatistic": lambda: jd.OrderStatistic(jd.Normal(), 5, 2),
    "HeterogeneousMixture": lambda: jd.HeterogeneousMixture(
        (jd.Normal(0.0, 1.0), jd.Exponential(1.0)), jnp.log(e([0.4, 0.6]))),
    "Reshaped": lambda: jd.Reshaped(jd.MvNormalDiag(jnp.zeros(6), jnp.ones(6)), (2, 3)),
    "MatrixNormal": lambda: jd.MatrixNormal(
        e([[0.1, -0.2, 0.3], [0.0, 0.5, -1.0]]), e([[1.0, 0.0], [0.4, 1.2]]),
        e([[1.0, 0.0, 0.0], [0.2, 0.9, 0.0], [-0.1, 0.3, 1.1]])),
    "MvLogitNormal": lambda: jd.MvLogitNormal(e([0.2, -0.1, 0.4]),
                                             e([[1.0, 0.0, 0.0], [0.3, 0.8, 0.0],
                                                [0.1, -0.2, 1.2]])),
    "MatrixBeta": lambda: jd.MatrixBeta(3, 6.0, 7.0),
    "MatrixTDist": lambda: jd.MatrixTDist(
        5.0, e([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]), e([[1.0, 0.5], [0.5, 1.0]]),
        e([[1.0, 0.3, 0.2], [0.3, 1.0, 0.4], [0.2, 0.4, 1.0]])),
}
# the families with a cdf in the JAX package
CDF = ("Chisq", "FDist", "Semicircle", "Cosine", "Epanechnikov", "GeneralizedPareto",
       "GeneralizedExtremeValue", "Gompertz", "Erlang", "LogUniform", "NormalCanon",
       "Biweight", "Triweight", "SymTriangularDist", "PGeneralizedGaussian", "Lindley",
       "Kolmogorov", "KSOneSided", "Affine_Gamma", "Affine_Beta", "Affine_Logistic",
       "Censored", "Censored_lower", "OrderStatistic", "HeterogeneousMixture")
# the families whose quantile the JAX family gives in closed form or by
# its generic solve on the cdf (every continuous one with a cdf)
QUANTILE = ("Chisq", "FDist", "Semicircle", "Cosine", "Epanechnikov", "GeneralizedPareto",
            "GeneralizedExtremeValue", "Gompertz", "Erlang", "LogUniform", "NormalCanon",
            "Biweight", "Triweight", "SymTriangularDist", "PGeneralizedGaussian", "Lindley",
            "Kolmogorov", "KSOneSided", "Affine_Gamma", "Affine_Beta", "Affine_Logistic",
            "OrderStatistic")
# the JAX test matrix's heavy-tailed rows, whose random inputs it scales down
SCALE_DOWN = ("FDist", "NoncentralF", "StudentizedRange", "PGeneralizedGaussian")


def spec(d):
    """`spec_of`, with the wrappers' nested specs: a tuple of components, a
    base with its float bounds, loc and scale, its static counts and
    shape."""
    kind = type(d).__name__
    if kind == "HeterogeneousMixture":
        return {"type": kind, "components": [spec(c) for c in d.components],
                "params": {"log_weights": np.asarray(d.log_weights)}}
    if kind in ("Affine", "Censored", "OrderStatistic", "Reshaped"):
        out = {"type": kind, "base": spec(d.base), "params": {}}
        for f in ("loc", "scale", "lower", "upper"):
            if hasattr(d, f):
                out["params"][f] = np.asarray(getattr(d, f))
        for f in ("n", "rank", "shape"):
            if hasattr(d, f):
                out[f] = getattr(d, f)
        return out
    return spec_of(d)


def port(d):
    return tbt.dist_from_spec(spec(d), **CPU64)


def close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), **tol)


# the points of every check: one shape, so that the JAX package's eager
# operations compile once
N = 8


def points(tdist, n, seed):
    """n points of the support: the port's draws (their law is held to the
    JAX family's by `test_draws_in_distribution`)."""
    return tdist.sample(torch.Generator().manual_seed(seed), (n,)).numpy().copy()


def jax_with(jdist, values):
    """The JAX distribution with its leaves replaced: {path: value}, paths
    as the port's `_tensor_leaves` gives them."""
    own, inner = {}, {}
    for path, v in values.items():
        if len(path) == 1:
            own[path[0]] = v
        else:
            inner.setdefault(path[0], {})[path[1:]] = v
    for k, sub in inner.items():
        own[k] = jax_with(getattr(jdist, k), sub)
    return dataclasses.replace(jdist, **own)


def jax_leaves(jdist, tdist):
    """{path: the JAX family's value} for each of the port's tensor leaves."""
    out = {}
    for path, _ in _tensor_leaves(tdist):
        v = jdist
        for k in path:
            v = getattr(v, k)
        out[path] = jnp.asarray(v, jnp.float64)
    return out


def port_grads(tdist, fn, x):
    """(fn(dist, x), d sum / dx, {path: d sum / d leaf}) through the port's
    tensor leaves, x a float64 array."""
    leaves = {p: v.detach().clone().requires_grad_(True) for p, v in _tensor_leaves(tdist)}
    xt = torch.as_tensor(x).clone().requires_grad_(True)
    out = fn(_with_leaves(tdist, leaves) if leaves else tdist, xt)
    wrt = [xt, *leaves.values()]
    gs = torch.autograd.grad(out.sum(), wrt, allow_unused=True)
    gs = [torch.zeros_like(v) if g is None else g for g, v in zip(gs, wrt)]
    return out, gs[0], dict(zip(leaves, gs[1:]))


# the JAX references compile at LLVM's lowest optimisation level: the same
# IEEE arithmetic, in half the compile time
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}


def jit(f, *args):
    """f(*args) through one quick `jax.jit` compile."""
    return jax.jit(f).lower(*args).compile(compiler_options=FAST)(*args)


def jax_density_and_grads(jdist, x, leaves, fn):
    """(fn(dist, x), (its gradient in x, {path: in the leaf})) of the JAX
    family by one `jax.vjp`, traceable: the tests run it under one
    `jax.jit` a family, where eager operations would compile one a
    primitive."""
    def f(xx, vals):
        return fn(jax_with(jdist, vals) if vals else jdist, xx)

    out, pull = jax.vjp(f, x, leaves)
    return out, pull(jnp.ones_like(out))


def jax_implicit_quantile(jdist, x, q, leaves):
    """At x (the port's solve of cdf(x) = q): the JAX quantile it implies,
    x - (cdf(x) - q) / pdf(x), and the JAX package's implicit-function
    rule for the generic quantile (`tpu_bijectors/dists/base.py::
    _generic_quantile_jvp`) as the gradient of sum x: 1 / pdf(x) in q,
    -sum dcdf/dtheta(x) / pdf(x) in each leaf, dcdf/dtheta by `jax.vjp`
    or, where the JAX cdf has no derivative in the leaf (betainc's a and
    b), by the rule's central differences at eps^(1/3) (|theta| + 1)."""
    d = jax_with(jdist, leaves) if leaves else jdist
    pdf = jnp.exp(d.logpdf(x))
    w = -1.0 / pdf
    grads = {}
    for path, v in leaves.items():
        def cdf_at(t, path=path):
            return jax_with(jdist, {**leaves, path: t}).cdf(x)

        try:
            _, pull = jax.vjp(cdf_at, v)
            grads[path] = pull(w)[0]
        except ValueError:
            h = float(jnp.finfo(x.dtype).eps) ** (1.0 / 3.0) * (jnp.abs(v) + 1.0)
            grads[path] = jnp.sum(w * (cdf_at(v + h) - cdf_at(v - h)) / (2.0 * h))
    return x - (d.cdf(x) - q) / pdf, (1.0 / pdf, grads)


def fd_leaf(tdist, path):
    """Whether the port takes the cdf's partial in this leaf by central
    differences (its owner's `_cdf_fd`)."""
    owner = tdist
    for k in path[:-1]:
        owner = getattr(owner, k)
    return path[-1] in getattr(owner, "_cdf_fd", ())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_density_link_and_linked_density(name):
    """logpdf at points of the support and its gradient in x and in every
    tensor leaf; the registry link (`to_linked_vec` of the leaf), its
    inverse and both log-dets; the linked density through `unconstrain`
    at the linked points, and, where the fused plan serves the leaf, its
    tape's value and gradient in v."""
    jdist = FAMILIES[name]()
    tdist = port(jdist)
    x = points(tdist, N, 0)
    lp, gx, gl = port_grads(tdist, lambda d, z: d.logpdf(z), x)
    uj, ut = junconstrain(jdist), tbt.unconstrain(tdist, device="cpu")

    def ref(z, vals):
        # the density and its gradients at `vals`; the link, the linked
        # density and its gradient in v of the family as built (its leaves
        # constants of the compile); one compile in all
        lp_, grads = jax_density_and_grads(jdist, z, vals, lambda d, zz: d.logpdf(zz))
        v_, ld_ = uj.to_linked_vec(z)
        ll_, pull = jax.vjp(uj.linked_logdensity, v_)
        return lp_, grads, v_, ld_, ll_, pull(jnp.ones_like(ll_))[0]

    jlp, (jgx, jgl), jv, jld, jll, jgv = jit(ref, e(x), jax_leaves(jdist, tdist))
    close(lp, jlp, VAL)
    close(gx, jgx, DER)
    for path, g in gl.items():
        close(g, jgl[path], DER)
    tb = tbt.bijector(tdist)
    assert type(tb).__name__ == type(jbijector(jdist)).__name__
    assert ut.linked_vec_length == uj.linked_vec_length
    v, ld = ut.to_linked_vec(torch.as_tensor(x))
    close(v, jv, VAL)
    close(ld, jld, VAL)
    xx, ild = ut.from_linked_vec(v)
    close(xx, x, VAL)
    close(ild, -ld, VAL)
    jv = torch.as_tensor(np.asarray(jv))
    close(ut.linked_logdensity(jv), jll, VAL)
    # where the fused plan serves the leaf, its traced entry's tape (the
    # plain evaluator of the kernels' interpreter) gives the same value and
    # gradient in v (the plan decision itself: test_torch_plan_decisions)
    plan = fp._plan(ut)
    if plan is not None:
        (entry,) = plan
        tape = entry.tape
        val, par = ft.traced_val_par(tape, tape.params(torch.float64), jv.T.contiguous(),
                                     True, True)
        close(val, jll, TAPE)
        close(par, np.asarray(jgv).T, TAPE)


@pytest.mark.parametrize("name", CDF)
def test_cdf_quantile_and_its_implicit_derivative(name):
    """The cdf at points of the support; the quantile at eight levels (its
    closed form, against the JAX family's; the generic solve, against the
    JAX quantile its solve implies) and its derivative in q and in every
    tensor leaf (the JAX package's implicit rule for the generic one)."""
    jdist = FAMILIES[name]()
    tdist = port(jdist)
    x = points(tdist, N, 1)
    close(tdist.cdf(torch.as_tensor(x)), jit(jdist.cdf, e(x)), VAL)
    if name not in QUANTILE:
        return
    q = np.linspace(0.05, 0.95, N)
    xq, gq, gl = port_grads(tdist, lambda d, z: d.quantile(z), q)
    leaves = jax_leaves(jdist, tdist)
    if type(jdist).quantile is jd.Distribution.quantile:
        # the JAX family's generic solve: its implicit rule at the port's
        # solve, and the JAX quantile it implies (one Newton step on the
        # JAX cdf), without tracing the bisection
        x_j, (jgq, jgl) = jit(lambda z, w, vals: jax_implicit_quantile(jdist, z, w, vals),
                              e(xq.detach().numpy()), e(q), leaves)
    else:
        x_j, (jgq, jgl) = jit(lambda z, vals: jax_density_and_grads(
            jdist, z, vals, lambda d, zz: d.quantile(zz)), e(q), leaves)
    close(xq, x_j, DER)
    close(gq, jgq, QDER)
    for path, g in gl.items():
        close(g, jgl[path], QDER_FD if fd_leaf(tdist, path) else QDER)


# scipy's law of each family with no cdf in the JAX package
SCIPY = {
    "VonMises": lambda: scipy.stats.vonmises(2.0, loc=0.5),
    "Rician": lambda: scipy.stats.rice(0.5, scale=1.0),
    "NoncentralChisq": lambda: scipy.stats.ncx2(2.0, 3.0),
    "NoncentralF": lambda: scipy.stats.ncf(2.0, 3.0, 1.0),
    "NoncentralT": lambda: scipy.stats.nct(2.0, 3.0),
}


def _numeric_cdf(tdist, x):
    """The cdf at x by the trapezoid rule on the port's density (held to
    the JAX family's by `test_density_link_and_linked_density`) over a grid from
    the support's end or the draws' least value."""
    s = tdist.support
    lo = s.lower if s.lower_finite else float(x.min()) - 1.0
    grid = torch.linspace(lo, float(x.max()), 2001, dtype=torch.float64)
    pdf = torch.exp(tdist.logpdf(grid[1:-1]))
    pdf = torch.cat([pdf[:1] * 0.0, pdf, pdf[-1:] * 0.0]).numpy()
    g = grid.numpy()
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(g))])
    return np.interp(x, g, cum / cum[-1])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_draws_in_distribution(name):
    """2000 draws from a torch.Generator, in the support, against their law
    by scipy's Kolmogorov-Smirnov test (p > 1e-3): the family's cdf (the
    port's, held to the JAX family's by the cdf test);
    with none, scipy's own law of the family, or the trapezoid cdf of the
    density (NoncentralBeta, NormalInverseGaussian, SkewedExponentialPower,
    StudentizedRange; and HeterogeneousMixture, whose cdf, as the JAX
    family's, takes Exponential's cdf below 0 unclamped); a
    reshaped N(0, 1) entry by entry, MatrixNormal's and MvLogitNormal's
    normal coordinates; Censored's atoms within 5 standard errors of the
    base's tail masses and its interior against the base's cdf;
    a diagonal entry of MatrixBeta and two entries of MatrixTDist against
    their Beta and Student t marginals."""
    jdist = FAMILIES[name]()
    tdist = port(jdist)
    x = tdist.sample(torch.Generator().manual_seed(3), (2000,))
    assert x.shape == (2000,) + tuple(tdist.event_shape)
    assert bool(torch.all(tdist.in_support(x, atol=1e-9)))
    x = x.numpy()
    if name.startswith("Censored"):
        base = jdist.base
        inside = np.ones_like(x, dtype=bool)
        for bound, mass in ((jdist.lower, lambda b: base.cdf(b)),
                            (jdist.upper, lambda b: 1.0 - base.cdf(b))):
            if np.isfinite(bound):
                at = x == bound
                m = float(mass(bound))
                assert abs(at.mean() - m) <= 5.0 * np.sqrt(m * (1.0 - m) / x.size)
                inside &= ~at
        lo = float(base.cdf(jdist.lower)) if np.isfinite(jdist.lower) else 0.0
        hi = float(base.cdf(jdist.upper)) if np.isfinite(jdist.upper) else 1.0
        tbase = tdist.base
        p = scipy.stats.kstest(
            x[inside], lambda z: (tbase.cdf(torch.as_tensor(z)).numpy() - lo) / (hi - lo)).pvalue
    elif name == "Reshaped":
        p = scipy.stats.kstest(x.reshape(-1), scipy.stats.norm.cdf).pvalue
    elif name == "MatrixNormal":
        U, V = np.asarray(jdist.row_chol), np.asarray(jdist.col_chol)
        sd = np.sqrt((U @ U.T)[1, 1] * (V @ V.T)[2, 2])
        p = scipy.stats.kstest((x[:, 1, 2] - float(jdist.loc[1, 2])) / sd, "norm").pvalue
    elif name == "MvLogitNormal":
        L = np.asarray(jdist.scale_tril)
        y = np.log(x[:, 1] / x[:, -1])
        p = scipy.stats.kstest((y - float(jdist.loc[1])) / np.sqrt((L @ L.T)[1, 1]), "norm").pvalue
    elif name == "MatrixBeta":
        # a principal 1 x 1 block of B_p(a, b) is Beta(a, b) (Gupta and
        # Nagar thm 5.3.8), a = n1 / 2, b = n2 / 2
        law = scipy.stats.beta(0.5 * float(jdist.n1), 0.5 * float(jdist.n2))
        p = min(scipy.stats.kstest(x[:, i, i], law.cdf).pvalue for i in (0, 2))
    elif name == "MatrixTDist":
        # X_ij = M_ij + sqrt(Sigma_ii Omega_jj / nu) t_nu
        S, O, M = (np.asarray(getattr(jdist, k)) for k in ("row_scale", "col_scale", "loc"))
        nu = float(jdist.df)
        p = min(scipy.stats.kstest((x[:, i, j] - M[i, j]) / np.sqrt(S[i, i] * O[j, j] / nu),
                                   scipy.stats.t(nu).cdf).pvalue for i, j in ((0, 0), (1, 2)))
    elif name in CDF and name != "HeterogeneousMixture":
        # the port's cdf, held to the JAX family's by the cdf test
        p = scipy.stats.kstest(x, lambda z: tdist.cdf(torch.as_tensor(z)).numpy()).pvalue
    elif name in SCIPY:
        p = scipy.stats.kstest(x, SCIPY[name]().cdf).pvalue
    else:
        p = scipy.stats.kstest(x, lambda z: _numeric_cdf(tdist, z)).pvalue
    assert p > 1e-3, p


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_property_sweep(name):
    """`testing.test_all`, with the JAX test matrix's arguments."""
    d = port(FAMILIES[name]())
    assert test_all(d, inverse_scale=0.5 if name in SCALE_DOWN else 1.0)


def test_dist_from_spec_takes_every_wrapper_and_array_statics():
    """A Reshaped shape and an Affine loc as arrays, a tuple of component
    specs, and a tensor loc over a bounded base raising as in JAX."""
    a = tbt.dist_from_spec({"type": "Reshaped", "params": {"shape": np.array([3, 2])},
                            "base": spec(jd.MvNormalDiag(jnp.zeros(6), jnp.ones(6)))}, **CPU64)
    assert a.event_shape == (3, 2)
    b = port(jd.affine(jd.Normal(0.0, 1.0), e([0.5, 1.0]), 2.0))
    close(b.logpdf(torch.tensor([0.3, 0.1], dtype=torch.float64)),
          jd.affine(jd.Normal(0.0, 1.0), e([0.5, 1.0]), 2.0).logpdf(e([0.3, 0.1])), VAL)
    with pytest.raises(ValueError, match="tensor loc"):
        tbt.dists.Affine(tbt.dists.Gamma(2.0, 1.0, **CPU64), torch.tensor([1.0, 2.0])).support
    c = port(FAMILIES["HeterogeneousMixture"]())
    assert len(c.components) == 2 and c.support.kind == "interval"
    # the affine algebra nests into one Affine, as the JAX package's
    d = (tbt.dists.Logistic(0.0, 1.0, **CPU64) * 3 + 2) - 1
    assert isinstance(d, tbt.dists.Affine) and d.loc == 1.0 and d.scale == 3.0
    assert -d is not None and (-d).scale == -3.0
