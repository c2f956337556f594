"""The slab-served families, arraydist, transformed distributions, IID
blocks of structured leaves and LKJCholesky against the JAX package.

Same numpy inputs, float64 on the CPU. Each scalar family: logpdf, the
link both ways, the linked density (its telescoped hook), and the fused
slab's coefficient table, value and partials (the plain versions of the
whole-model kernels) against the JAX package's and against the composed
path, also at +-1e10 states. On the CPU the port's wrappers run the plain
versions; chip_smoke.py holds the CUDA kernels to them on the card. The
whole-family model: tests/test_torch_families_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CPU64, spec_of

import tpu_bijectors as tb
from tpu_bijectors import dists as jd
from tpu_bijectors.kernels.lkj import lkj_logdet_pallas
from tpu_bijectors.vectorize import fused_base as jfb
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.bijectors import Truncated, VecCholeskyBijector
from tpu_bijectors_torch.kernels import lkj as klkj
from tpu_bijectors_torch.vectorize import fused_base as tfb
from tpu_bijectors_torch.vectorize import fused_kernel as tfk

VAL = dict(rtol=1e-12, atol=1e-12)
DER = dict(rtol=1e-10, atol=1e-10)


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), **tol)


def _port(jdist):
    return tbt.dist_from_spec(spec_of(jdist), **CPU64)


def _pair(jdist):
    return junconstrain(jdist), tbt.unconstrain(_port(jdist), device="cpu")


# the 19 continuous families of the slice, with the `families` model's
# parameters
FAMILIES = {
    "StudentT": lambda: jd.StudentT(4.5, 0.3, 1.7),
    "Cauchy": lambda: jd.Cauchy(-0.4, 0.9),
    "Laplace": lambda: jd.Laplace(0.2, 1.3),
    "Logistic": lambda: jd.Logistic(0.1, 0.8),
    "Gumbel": lambda: jd.Gumbel(-0.3, 1.1),
    "Gamma": lambda: jd.Gamma(2.0, 1.5),
    "Exponential": lambda: jd.Exponential(0.8),
    "InverseGamma": lambda: jd.InverseGamma(3.0, 2.0),
    "HalfNormal": lambda: jd.HalfNormal(1.4),
    "HalfCauchy": lambda: jd.HalfCauchy(0.7),
    "Weibull": lambda: jd.Weibull(1.8, 2.1),
    "Chi": lambda: jd.Chi(3.0),
    "Rayleigh": lambda: jd.Rayleigh(1.2),
    "Frechet": lambda: jd.Frechet(2.3, 1.4),
    "Beta": lambda: jd.Beta(2.5, 1.6),
    "Uniform": lambda: jd.Uniform(-2.0, 5.0),
    "LogitNormal": lambda: jd.LogitNormal(0.2, 0.9),
    "Pareto": lambda: jd.Pareto(2.2, 1.5),
    "Levy": lambda: jd.Levy(0.4, 1.3),
}


def _states(rng, dim, n=7):
    """(n, dim) states 0.7 N(0, 1), then four columns of the transposed
    state at +1e10, -1e10 and mixed signs: (v, vT normal, vT extreme)."""
    v = 0.7 * rng.standard_normal((n, dim))
    ext = 1e10 * np.sign(rng.standard_normal((dim, 4)))
    ext[:, 0], ext[:, 1] = 1e10, -1e10
    return v, np.ascontiguousarray(v.T), ext


def _slab_ref(u_j, vT):
    """The JAX package's slab value (with c0) and partials of its own
    coefficient table on vT."""
    ref = jfk._prep(u_j, jnp.asarray(vT))
    cf = ref[8]
    val, par = jfb._slab_segment_val_par(
        tuple(jfb._WEIGHT_OF), jnp.asarray(vT), cf, frozenset(jfb._COEF_KEYS),
        value=True, partial=True,
    )
    return cf, np.asarray(jnp.sum(val, 0) + ref[12]), np.asarray(par)


def _finite_close(got, ref, tol):
    """The same finite / +-inf pattern, no NaN, and the finite values
    within tol."""
    got = got.detach().numpy()
    assert not np.isnan(got).any() and not np.isnan(ref).any()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    np.testing.assert_allclose(got[fin], ref[fin], **tol)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_matches_jax(rng, name):
    """The family alone and as an IID block: logpdf, the link both ways,
    the linked density (the hook), and the fused slab's table, value and
    partials against the JAX package's and the composed path, at N(0, 1)
    and +-1e10 states."""
    jdist = FAMILIES[name]()
    d = jd.NamedProduct.of(x=jdist, iid=jd.IIDProduct(jdist, 3))
    u_j, u_t = _pair(d)
    v, vT, ext = _states(rng, 4)
    vt = torch.as_tensor(v)
    # the link both ways and the logpdf
    xj, ldj = jax.jit(u_j.from_linked_vec)(jnp.asarray(v))
    xt, ldt = u_t.from_linked_vec(vt)
    for k in ("x", "iid"):
        _close(xt[k], xj[k], VAL)
    _close(ldt, ldj, VAL)
    _close(_port(jdist).logpdf(xt["iid"]), jdist.logpdf(xj["iid"]), VAL)
    v2, ld2 = u_t.to_linked_vec(xt)
    _close(v2, v, dict(rtol=1e-9, atol=1e-9))
    _close(ld2, jax.jit(u_j.to_linked_vec)(xj)[1], dict(rtol=1e-10, atol=1e-10))
    # the linked density: the telescoped hook (batch-major), with x
    _close(u_t.linked_logdensity(vt), jax.jit(u_j.linked_logdensity)(jnp.asarray(v)), VAL)
    x_h, lp_h = u_t.from_linked_vec_with_logpdf(vt)
    xj_h, lpj_h = jax.jit(u_j.from_linked_vec_with_logpdf)(jnp.asarray(v))
    _close(x_h["x"], xj_h["x"], VAL)
    _close(lp_h, lpj_h, VAL)
    # the fused slab: coefficient table, value and partials
    for state in (vT, ext):
        cf_j, lp_j, g_j = _slab_ref(u_j, state)
        cf, _, c0 = tfk._prep(u_t, torch.as_tensor(state))
        _close(cf, cf_j, dict(rtol=1e-12, atol=1e-14))
        lp, g = tfb.slab_value_and_grad_plain(torch.as_tensor(state), cf)
        _finite_close(lp + c0, lp_j, VAL)
        _finite_close(g, g_j, DER)
    # against the composed path, value and gradient
    w = torch.as_tensor(vT).requires_grad_(True)
    lp = u_t.linked_logdensity_t(w)
    (g,) = torch.autograd.grad(lp.sum(), w)
    w2 = torch.as_tensor(vT).requires_grad_(True)
    comp = u_t._linked_logdensity_t_children(w2)
    (g2,) = torch.autograd.grad(comp.sum(), w2)
    _close(lp, comp.detach(), VAL)
    _close(g, g2, DER)


def test_registry_links_of_the_families():
    """Each family's registry link is the branch its support selects, and
    each hook recognises it."""
    from tpu_bijectors_torch.dists import univariate as uv

    ident = ("StudentT", "Cauchy", "Laplace", "Logistic", "Gumbel")
    for name, make in FAMILIES.items():
        d = _port(make())
        b = tbt.bijector(d)
        assert (type(b).__name__ == "Identity") == (name in ident), name
        if name not in ident:
            assert type(b) is Truncated and d.fused_linked_logdensity(
                b, torch.zeros(2, dtype=torch.float64)) is not None, name
    assert uv._is_shifted_log_link(tbt.bijector(_port(jd.Pareto(2.2, 1.5))), 1.5)
    assert not uv._is_log_link(tbt.bijector(_port(jd.Pareto(2.2, 1.5))))
    assert uv._is_interval_logit_link(tbt.bijector(_port(jd.Uniform(-2.0, 5.0))), -2.0, 5.0)


# ---------------------------------------------------------------------------
# arraydist, transformed, IID blocks of structured leaves, LKJCholesky
# ---------------------------------------------------------------------------

CASES = {
    # per-element parameters: a coefficient column a row
    "arraydist": lambda: jd.NamedProduct.of(
        ad=jd.arraydist(jd.Normal(jnp.asarray([-1.0, 0.0, 2.0]), jnp.asarray([0.5, 1.0, 2.0]))),
        adg=jd.arraydist(jd.Gamma(jnp.asarray([2.0, 3.5]), jnp.asarray([1.0, 0.7]))),
        adb=jd.arraydist(jd.Beta(jnp.asarray([2.5, 0.8]), jnp.asarray([1.6, 3.0]))),
        adt=jd.arraydist(jd.StudentT(jnp.asarray([3.0, 7.5]), 0.2, jnp.asarray([1.1, 0.4]))),
    ),
    # the linked density telescopes to the base's rows
    "transformed": lambda: jd.NamedProduct.of(
        tdb=tb.transformed(jd.Beta(2.0, 3.0)),
        tdg=tb.transformed(jd.Gamma(2.0, 1.5)),
        tdl=tb.transformed(jd.LKJ(3, 1.5)),
        mu=jd.Normal(0.1, 1.2),
    ),
    # shifted-row copies; the loop copies share one parameter block
    "iid_structured": lambda: jd.NamedProduct.of(
        iidc=jd.IIDProduct(jd.LKJ(3, 1.5), 2),
        iidd=jd.IIDProduct(jd.Dirichlet(jnp.asarray([1.3, 2.0, 0.8, 1.1])), 2),
        iidw=jd.IIDProduct(jd.Wishart(6.0, jnp.eye(3)), 2),
        iidl=jd.IIDProduct(jd.LKJCholesky(4, 2.5), 2),
    ),
    "lkj_cholesky": lambda: jd.NamedProduct.of(
        lc=jd.LKJCholesky(5, 1.5),
        lcu=jd.LKJCholesky(4, 0.7, "U"),
    ),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    d = CASES[request.param]()
    u_j, u_t = _pair(d)
    rng = np.random.default_rng(17)
    vT = np.ascontiguousarray(0.6 * rng.standard_normal((11, u_t.linked_vec_length)).T)
    return request.param, u_j, u_t, vT, rng.standard_normal(11)


def test_case_links_and_linked_density_match_jax(case):
    """from_linked_vec, to_linked_vec and both layouts' linked densities
    (the Cholesky link's log-det alone is #5's chol=True plain version)."""
    _, u_j, u_t, vT, _ = case
    v = np.ascontiguousarray(vT.T)
    xj, ldj = jax.jit(u_j.from_linked_vec)(jnp.asarray(v))
    xt, ldt = u_t.from_linked_vec(torch.as_tensor(v))
    assert sorted(xt) == sorted(xj)
    for k in xj:
        _close(xt[k], xj[k], VAL)
    _close(ldt, ldj, VAL)
    v2, ld2 = u_t.to_linked_vec(xt)
    _close(v2, v, dict(rtol=1e-9, atol=1e-9))
    _close(ld2, jax.jit(u_j.to_linked_vec)(xj)[1], dict(rtol=1e-10, atol=1e-10))
    ref = jax.jit(u_j.linked_logdensity)(jnp.asarray(v))
    _close(u_t.linked_logdensity(torch.as_tensor(v)), ref, VAL)
    _close(u_t._linked_logdensity_t_children(torch.as_tensor(vT)), ref, VAL)
    _close(u_t.from_linked_vec_with_logpdf(torch.as_tensor(v))[1],
           jax.jit(u_j.from_linked_vec_with_logpdf)(jnp.asarray(v))[1], VAL)


def test_case_fused_matches_jax_kernels(case):
    """The plan's table against the JAX package's, the fused value and
    gradient against its one-pass mega kernel in interpret mode, and the
    vector-Jacobian product (autograd) against that gradient."""
    name, u_j, u_t, vT, ct = case
    ref = jfk._prep(u_j, jnp.asarray(vT))
    cf, loops, c0 = tfk._prep(u_t, torch.as_tensor(vT))
    _close(cf, ref[8], dict(rtol=1e-12, atol=1e-14))
    _close(c0, ref[12], VAL)
    if name == "iid_structured":
        (a, b) = [e for e in loops.entries]
        assert a[3] == b[3]  # the two Wishart copies read one block
    lp, g = tbt.Model(_port(CASES[name]()), device="cpu").batched_logdensity_t_fn(
    ).value_and_grad_fn(torch.as_tensor(vT))
    rlp, rg = jax.jit(lambda v: jfk.mega_value_and_grad_t(u_j, v, interpret=True))(
        jnp.asarray(vT))
    _close(lp, rlp, VAL)
    _close(g, rg, DER)
    w = torch.as_tensor(vT).requires_grad_(True)
    (gv,) = torch.autograd.grad(u_t.linked_logdensity_t(w), w, torch.as_tensor(ct))
    _close(gv, g * torch.as_tensor(ct), DER)


def test_lkj_logdet_chol_plain_matches_jax_kernel(rng):
    """#5's chol=True variant: the plain version against the JAX package's
    kernel in interpret mode, and the Cholesky link's log-det alone against
    its full inverse."""
    K = 5
    y = 1.1 * rng.standard_normal((8, K * (K - 1) // 2))
    rlj, rld = lkj_logdet_pallas(jnp.asarray(y), K, chol=True, interpret=True)
    lj, ld = klkj.lkj_logdet_plain(torch.as_tensor(y), K, chol=True)
    _close(lj, rlj, VAL)
    _close(ld, rld, VAL)
    b = VecCholeskyBijector("L")
    lj2, ld2 = b.inverse_log_det_and_factor_only(torch.as_tensor(y))
    X, lj3, ld3 = b.inverse_and_log_det_with_factor(torch.as_tensor(y))
    _close(lj2, lj3, VAL)
    _close(ld2, ld3, VAL)
    _close(torch.log(torch.diagonal(X, dim1=-2, dim2=-1)), ld3, VAL)


def test_lkj_cholesky_logpdf_matches_jax(rng):
    for mode in ("L", "U"):
        jdist = jd.LKJCholesky(4, 2.5, mode)
        X = np.array(jdist.sample(jax.random.PRNGKey(3), (6,)))
        _close(_port(jdist).logpdf(torch.as_tensor(X)), jdist.logpdf(jnp.asarray(X)), VAL)
        b = tbt.bijector(_port(jdist))
        assert b == VecCholeskyBijector(mode)
        y, ld = b.forward_and_log_det(torch.as_tensor(X))
        yj, ldj = tb.bijector(jdist).forward_and_log_det(jnp.asarray(X))
        _close(y, yj, DER)
        _close(ld, ldj, DER)


def test_nested_iid_is_one_leaf_as_in_jax(rng):
    """A nested IID chain of one family is one leaf (the composed path
    serves it; the fused plan declines it on the CPU, as the JAX package's
    hand-written plan does)."""
    d = jd.NamedProduct.of(m=jd.IIDProduct(jd.IIDProduct(jd.Gamma(2.0, 1.5), 3), 2),
                           s=jd.Normal(0.0, 1.0))
    u_j, u_t = _pair(d)
    assert tfk._plan(u_t) is None
    v = 0.6 * rng.standard_normal((5, u_t.linked_vec_length))
    _close(u_t.linked_logdensity(torch.as_tensor(v)), u_j.linked_logdensity(jnp.asarray(v)), VAL)
    _close(u_t.linked_logdensity_t(torch.as_tensor(np.ascontiguousarray(v.T))),
           u_j.linked_logdensity(jnp.asarray(v)), VAL)
