"""The port's dense multivariate families, their loop entries, the
forward-mode whole-model function and the LKJ inverse at K = 64 against
the JAX package.

Same numpy inputs, float64 on the CPU. The families' logpdf against the
JAX package and scipy, and their linked densities against the JAX
package's; the whole-model value, vector-Jacobian product, forward-mode
product (`torch.func.jvp`, whose tangent is the jvp of `_SlabLogDensity`)
and one-pass value-and-gradient with the Gaussian and t loop entries
against the JAX package's mega kernels in interpret mode and against
jax.jvp / jax.vjp of its composed path; the plain forward-mode function on
the slab and PD models against `mega_jvp_t`; the plan's K limit; a short
NUTS run through `kernel='auto'`. On the CPU the port's wrappers run the
plain versions; chip_smoke.py holds the CUDA kernels to them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as ss
import torch
from test_torch_fused import ATOL, CPU64, RTOL, spec_of
from test_torch_nuts import _picked

from tpu_bijectors import dists as jd
from tpu_bijectors.bijectors.corr import VecCorrBijector as JVecCorr
from tpu_bijectors.infer import Model as JModel
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import diagnostics, kernels
from tpu_bijectors_torch.bijectors.base import Block, Identity
from tpu_bijectors_torch.bijectors.scalar import Truncated
from tpu_bijectors_torch.kernels import lkj as klkj
from tpu_bijectors_torch.vectorize import fused_base as tfb
from tpu_bijectors_torch.vectorize import fused_kernel as tfk
from tpu_bijectors_torch.vectorize.fused_plan import _plan_with_reason

# the JAX package's own tolerances for its mv mega kernels
# (tests/test_transposed_layout.py::test_mega_kernel_mv_leaves): the kernels
# contract against a host-formed triangular inverse, not bitwise
VAL_TOL = dict(rtol=1e-11, atol=1e-11)
DER_TOL = dict(rtol=1e-9, atol=1e-10)
FAM_TOL = dict(rtol=1e-12, atol=0)


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), **tol)


# ---------------------------------------------------------------------------
# the families: logpdf against the JAX package and scipy
# ---------------------------------------------------------------------------

_A3 = np.asarray([[2.0, 0, 0], [0.3, 1.5, 0], [-0.2, 0.1, 1.0]])
_J3 = np.asarray([[4.0, -2.0, -1.0], [-2.0, 5.0, -1.0], [-1.0, -1.0, 6.0]])
_A4 = np.tril(np.random.default_rng(0).standard_normal((4, 4))) + 2.0 * np.eye(4)
_X3 = np.asarray([[0.3, 0.1, 1.0], [-0.4, 0.8, -1.2]])


def _x(K):
    return np.random.default_rng(K).standard_normal((16, K))


# name -> (JAX family, points, scipy logpdf); the cases of the JAX package's
# tests/test_dists_scipy.py:98, test_dists_scipy2.py:235 and
# test_review_regressions.py:149-158, and one each for the other families
FAMILIES = {
    "tril3": (lambda: jd.MvNormalTril(jnp.asarray([0.5, -1.0, 2.0]), jnp.asarray(_A3)), _X3,
              lambda x: ss.multivariate_normal.logpdf(x, [0.5, -1.0, 2.0], _A3 @ _A3.T)),
    "canon3": (lambda: jd.MvNormalCanon(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray(_J3)), _X3,
               lambda x: ss.multivariate_normal.logpdf(
                   x, np.linalg.solve(_J3, [1.0, 2.0, 3.0]), np.linalg.inv(_J3))),
    "tril4_batched": (lambda: jd.MvNormalTril(jnp.zeros(4), jnp.asarray(_A4)), _x(4),
                      lambda x: ss.multivariate_normal.logpdf(x, np.zeros(4), _A4 @ _A4.T)),
    "t4": (lambda: jd.MvStudentT(5.0, jnp.zeros(4), jnp.asarray(_A4)), _x(4),
           lambda x: ss.multivariate_t.logpdf(x, np.zeros(4), _A4 @ _A4.T, df=5.0)),
    "t2": (lambda: jd.MvStudentT(3.5, jnp.asarray([0.1, -0.3]),
                                 jnp.asarray([[1.1, 0.0], [0.5, 0.7]])), _x(2),
           lambda x: ss.multivariate_t.logpdf(
               x, [0.1, -0.3], np.asarray([[1.1, 0], [0.5, 0.7]]) @ [[1.1, 0.5], [0, 0.7]],
               df=3.5)),
    "diag2": (lambda: jd.MvNormalDiag(jnp.asarray([0.2, -0.4]), jnp.asarray([0.7, 1.9])), _x(2),
              lambda x: ss.multivariate_normal.logpdf(x, [0.2, -0.4], np.diag([0.49, 3.61]))),
    "lognormal3": (lambda: jd.MvLogNormal(jnp.asarray([0.1, 0.0, -0.3]),
                                          jnp.asarray([0.5, 1.2, 0.8])),
                   np.exp(_x(3)),
                   lambda x: ss.multivariate_normal.logpdf(
                       np.log(x), [0.1, 0.0, -0.3], np.diag([0.25, 1.44, 0.64]))
                   - np.log(x).sum(-1)),
}


def _port(jdist):
    return tbt.dist_from_spec(spec_of(jdist), **CPU64)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_logpdf_matches_jax_and_scipy(name):
    make, x, ref = FAMILIES[name]
    jdist = make()
    got = _port(jdist).logpdf(torch.as_tensor(x))
    _close(got, jdist.logpdf(jnp.asarray(x)), FAM_TOL)
    _close(got, ref(x), dict(rtol=1e-10, atol=0))  # scipy: eigh / its own solves


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_linked_density_matches_jax(name):
    """Batch-major and transposed linked densities (the telescoped
    MvLogNormal and the MvNormalDiag hooks included) and the inverse link,
    against the JAX package's composed path."""
    jdist = FAMILIES[name][0]()
    u_j = junconstrain(jdist)
    u_t = tbt.unconstrain(_port(jdist), device="cpu")
    v = 0.7 * np.random.default_rng(5).standard_normal((6, u_t.linked_vec_length))
    ref = u_j.linked_logdensity(jnp.asarray(v))
    _close(u_t.linked_logdensity(torch.as_tensor(v)), ref, FAM_TOL)
    x, lp = u_t.from_linked_vec_with_logpdf(torch.as_tensor(v))
    xj, lpj = u_j.from_linked_vec_with_logpdf(jnp.asarray(v))
    _close(x, xj, FAM_TOL)
    _close(lp, lpj, FAM_TOL)
    vT = torch.as_tensor(np.ascontiguousarray(v.T))
    _close(u_t._linked_logdensity_t_children(vT), ref, FAM_TOL)
    _close(u_t.linked_logdensity_t(vT), ref, VAL_TOL)  # the fused plan


def test_registry_links():
    """real_vector -> elementwise Identity; MvLogNormal's positive vector
    support -> the elementwise lower-only Truncated, the log link."""
    for name in ("tril3", "canon3", "t2", "diag2"):
        assert tbt.bijector(_port(FAMILIES[name][0]())) == Block(Identity(), 1)
    b = tbt.bijector(_port(FAMILIES["lognormal3"][0]()))
    assert type(b) is Block and b.ndims == 1 and type(b.bijector) is Truncated
    from tpu_bijectors_torch.dists.univariate import _is_log_link

    assert _is_log_link(b.bijector)


def test_mvnormal_constructor_arities():
    loc = np.asarray([0.1, 0.2])
    cov = np.asarray([[2.0, 0.3], [0.3, 1.0]])
    x = torch.as_tensor(_x(2))
    for kw, ref in (
        (dict(cov=cov), jd.MvNormal(jnp.asarray(loc), jnp.asarray(cov))),
        (dict(cov=np.asarray([2.0, 1.0])), jd.MvNormal(jnp.asarray(loc), jnp.asarray([2.0, 1.0]))),
        (dict(scale_tril=np.linalg.cholesky(cov)),
         jd.MvNormal(jnp.asarray(loc), scale_tril=jnp.asarray(np.linalg.cholesky(cov)))),
        (dict(scale_diag=np.asarray([0.5, 2.0])),
         jd.MvNormal(jnp.asarray(loc), scale_diag=jnp.asarray([0.5, 2.0]))),
        ({}, jd.MvNormal(jnp.asarray(loc))),
    ):
        d = tbt.dists.MvNormal(loc, **kw, **CPU64)
        assert type(d).__name__ == type(ref).__name__
        _close(d.logpdf(x), ref.logpdf(jnp.asarray(x.numpy())), FAM_TOL)


# ---------------------------------------------------------------------------
# the whole-model functions with the Gaussian and t loop entries
# ---------------------------------------------------------------------------


def _mega_model_mv():
    """The JAX package's `_mega_model_mv` (tests/test_transposed_layout.py:
    183-201), plus an IID block of each loop kind and the slab families."""
    rng = np.random.default_rng(7)
    A = np.tril(rng.standard_normal((4, 4)) * 0.3) + 2.0 * np.eye(4)
    J = A @ A.T
    return jd.NamedProduct.of(
        mvt3=jd.MvNormalTril(jnp.asarray([0.5, -1.0, 0.2]),
                             jnp.asarray([[1.3, 0.0, 0.0], [0.4, 0.9, 0.0], [-0.2, 0.3, 1.6]])),
        mu=jd.Normal(0.0, 1.5),
        canon=jd.MvNormalCanon(jnp.asarray([0.2, -0.1, 0.4, 0.0]), jnp.asarray(J)),
        t=jd.MvStudentT(5.0, jnp.asarray([0.1, -0.3]), jnp.asarray([[1.1, 0.0], [0.5, 0.7]])),
        w=jd.Dirichlet(jnp.ones(4)),
        iid_tril=jd.IIDProduct(jd.MvNormalTril(jnp.asarray([0.3, 0.0]),
                                               jnp.asarray([[0.8, 0.0], [-0.3, 1.2]])), 2),
        iid_canon=jd.IIDProduct(jd.MvNormalCanon(jnp.asarray([0.5, -0.2, 0.1]),
                                                 jnp.asarray(_J3)), 2),
        iid_t=jd.IIDProduct(jd.MvStudentT(7.0, jnp.asarray([0.0, 0.4, -0.1]),
                                          jnp.asarray(_A3)), 2),
        ln=jd.MvLogNormal(jnp.asarray([0.1, -0.2]), jnp.asarray([0.6, 1.3])),
        diag=jd.MvNormalDiag(jnp.asarray([0.3, 0.0, -0.5]), jnp.asarray(0.9)),
    )


@pytest.fixture(scope="module")
def mv_case():
    d = _mega_model_mv()
    u_j = junconstrain(d)
    u_t = tbt.unconstrain(_port(d), device="cpu")
    rng = np.random.default_rng(23)
    dim = u_t.linked_vec_length
    vT = np.ascontiguousarray(0.6 * rng.standard_normal((19, dim)).T)
    dvT = np.ascontiguousarray(rng.standard_normal((19, dim)).T)
    ct = rng.standard_normal(19)
    return d, u_j, u_t, vT, dvT, ct


def test_mv_model_plan(mv_case):
    """Every leaf has an entry; IID copies of a loop family share one
    parameter block; the MvLogNormal and MvNormalDiag rows are slab rows,
    equal to the JAX package's coefficient table."""
    _, u_j, u_t, vT, _, _ = mv_case
    cf, loops, c0sum = tfk._prep(u_t, torch.as_tensor(vT))
    codes = [e[0] for e in loops.entries]
    assert codes == [3, 4, 5, 3, 3, 4, 4, 5, 5] and loops.kmax == 0
    assert len({e[3] for e in loops.entries}) == 6
    ref = jfk._prep(u_j, jnp.asarray(vT))
    _close(cf, ref[8], dict(rtol=1e-12, atol=1e-14))
    _close(c0sum, ref[12], dict(rtol=1e-12, atol=0))


def test_mv_model_value_matches_jax(mv_case):
    _, u_j, u_t, vT, _, _ = mv_case
    ref = jax.jit(lambda v: jfk.mega_logdensity_t(u_j, v, interpret=True))(jnp.asarray(vT))
    _close(u_t.linked_logdensity_t(torch.as_tensor(vT)), ref, VAL_TOL)
    _close(u_t.linked_logdensity_t(torch.as_tensor(vT)),
           jax.jit(u_j._linked_logdensity_t_children)(jnp.asarray(vT)), VAL_TOL)


def test_mv_model_jvp_matches_jax(mv_case):
    """torch.func.jvp of the fused density runs the Function's jvp (the
    plain forward-mode function on the CPU)."""
    _, u_j, u_t, vT, dvT, _ = mv_case
    lp, dlp = torch.func.jvp(u_t.linked_logdensity_t, (torch.as_tensor(vT),),
                             (torch.as_tensor(dvT),))
    vj, dvj = jnp.asarray(vT), jnp.asarray(dvT)
    _close(dlp, jax.jit(lambda v, d: jfk.mega_jvp_t(u_j, v, d, interpret=True))(vj, dvj),
           DER_TOL)
    ref_lp, ref = jax.jit(lambda v, d: jax.jvp(u_j._linked_logdensity_t_children, (v,), (d,)))(
        vj, dvj)
    _close(dlp, ref, DER_TOL)
    _close(lp, ref_lp, VAL_TOL)
    # forward-mode autograd reaches the same jvp
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        out = u_t.linked_logdensity_t(fwAD.make_dual(torch.as_tensor(vT), torch.as_tensor(dvT)))
        _close(fwAD.unpack_dual(out).tangent, ref, DER_TOL)


def test_mv_model_vjp_matches_jax(mv_case):
    _, u_j, u_t, vT, _, ct = mv_case
    v = torch.as_tensor(vT).requires_grad_(True)
    (g,) = torch.autograd.grad(u_t.linked_logdensity_t(v), v, torch.as_tensor(ct))
    vj, cj = jnp.asarray(vT), jnp.asarray(ct)
    _close(g, jax.jit(lambda v, c: jfk.mega_vjp_t(u_j, v, c, interpret=True))(vj, cj), DER_TOL)
    ref = jax.jit(lambda v, c: jax.vjp(u_j._linked_logdensity_t_children, v)[1](c)[0])(vj, cj)
    _close(g, ref, DER_TOL)


def test_mv_model_value_and_grad_matches_jax(mv_case):
    d, u_j, _, vT, _, _ = mv_case
    model = tbt.Model(_port(d), device="cpu")
    lp, g = model.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    ref_lp, ref_g = jax.jit(lambda v: jfk.mega_value_and_grad_t(u_j, v, interpret=True))(
        jnp.asarray(vT))
    _close(lp, ref_lp, VAL_TOL)
    _close(g, ref_g, DER_TOL)


def test_cpu_jvp_wrapper_runs_the_plain_version(mv_case):
    """A CPU tensor takes the plain forward-mode function and counts no
    launch; it equals the partials of the value-and-gradient function
    times the tangent."""
    _, _, u_t, vT, dvT, _ = mv_case
    vT, dvT = torch.as_tensor(vT), torch.as_tensor(dvT)
    cf, loops, _ = tfk._prep(u_t, vT)
    before = dict(kernels.LAUNCHES)
    got = tfk.slab_jvp(vT, cf, dvT, loops)
    assert torch.equal(got, tfb.slab_jvp_plain(vT, cf, dvT, loops))
    assert kernels.LAUNCHES == before
    _close(got, (tfb.slab_value_and_grad_plain(vT, cf, loops)[1] * dvT).sum(0), FAM_TOL)


# the plain forward-mode function on the models of the earlier slices
JVP_MODELS = {
    "bench": lambda: jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.0, 2.0), 8),
        sigma=jd.IIDProduct(jd.LogNormal(0.0, 0.5), 8),
        w=jd.Dirichlet(jnp.ones(16)),
        corr=jd.LKJ(16, 2.0),
    ),
    "pdonly": lambda: jd.NamedProduct.of(
        W=jd.Wishart(5.0, jnp.eye(3)), m=jd.IIDProduct(jd.Normal(0.0, 1.0), 2)
    ),
    "pdonly_iw": lambda: jd.NamedProduct.of(
        W=jd.InverseWishart(5.0, jnp.eye(3)), m=jd.IIDProduct(jd.Normal(0.0, 1.0), 2)
    ),
}


@pytest.mark.parametrize("name", list(JVP_MODELS))
def test_jvp_plain_matches_jax_mega_jvp(name):
    d = JVP_MODELS[name]()
    u_j = junconstrain(d)
    u_t = tbt.unconstrain(_port(d), device="cpu")
    rng = np.random.default_rng(3)
    dim = u_t.linked_vec_length
    vT = 0.5 * rng.standard_normal((dim, 16))
    dvT = rng.standard_normal((dim, 16))
    cf, loops, _ = tfk._prep(u_t, torch.as_tensor(vT))
    got = tfb.slab_jvp_plain(torch.as_tensor(vT), cf, torch.as_tensor(dvT), loops)
    ref = jfk.mega_jvp_t(u_j, jnp.asarray(vT), jnp.asarray(dvT), interpret=True)
    _close(got, ref, dict(rtol=RTOL, atol=ATOL))


# ---------------------------------------------------------------------------
# the plan's K limit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["MvNormalTril", "MvNormalCanon", "MvStudentT"])
def test_plan_declines_beyond_k16_naming_the_limit(family):
    """K = 17 > 16 (the JAX package's MAX_K["mvn"]): no plan, a CPU state
    takes the composed path, and `_prep` (what every CUDA call goes
    through) raises with the limit named."""
    K = 17
    L = np.eye(K) + 0.1 * np.tril(np.ones((K, K)), -1)
    d = {
        "MvNormalTril": lambda: tbt.dists.MvNormalTril(np.zeros(K), L, **CPU64),
        "MvNormalCanon": lambda: tbt.dists.MvNormalCanon(np.zeros(K), L @ L.T, **CPU64),
        "MvStudentT": lambda: tbt.dists.MvStudentT(4.0, np.zeros(K), L, **CPU64),
    }[family]()
    u = tbt.unconstrain(tbt.dists.NamedProduct.of(x=d), device="cpu")
    plan, reason = _plan_with_reason(u)
    assert plan is None and reason == f"{family} with K = 17 > 16"
    vT = torch.as_tensor(0.3 * np.random.default_rng(1).standard_normal((K, 3)))
    _close(u.linked_logdensity_t(vT), d.logpdf(vT.T), FAM_TOL)
    with pytest.raises(NotImplementedError, match="K = 17 > 16"):
        tfk._prep(u, vT)
    assert tbt.Model(tbt.dists.NamedProduct.of(x=d), device="cpu")._auto_kernel() == "nuts_batched"


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

_NUTS_LA = np.asarray([[1.0, 0.0, 0.0], [0.3, 0.8, 0.0], [-0.2, 0.1, 1.2]])
_NUTS_MU = np.asarray([0.5, -0.4, 0.2])


def _nuts_model():
    return jd.NamedProduct.of(
        x=jd.MvNormalTril(jnp.asarray(_NUTS_MU), jnp.asarray(_NUTS_LA)),
        t=jd.MvStudentT(5.0, jnp.asarray([0.1, -0.3]), jnp.asarray([[1.1, 0.0], [0.5, 0.7]])),
        c=jd.MvNormalCanon(jnp.asarray([0.2, -0.1]), jnp.asarray([[2.0, 0.3], [0.3, 1.0]])),
        ln=jd.MvLogNormal(jnp.asarray([0.1, -0.2]), jnp.asarray([0.6, 1.3])),
    )


def test_auto_picks_nuts_batched_t_for_the_mv_model(monkeypatch):
    jm = JModel(priors=_nuts_model(), loglik=None)
    tm = tbt.Model(_port(_nuts_model()), device="cpu")
    assert _picked(monkeypatch, tm, jm) == ["nuts_batched_t", "nuts_batched"]


def test_nuts_recovers_the_conjugate_gaussian_posterior():
    """20 observations z ~ N(theta, L L') on x (prior N(mu, L L')): x's
    posterior mean is (mu + sum z) / 21; the other leaves keep their prior
    means on the linked scale (t: its loc, df > 1; canon: J^-1 h; the
    log-normal's loc). 8 chains, 150 warmup + 150 draws through
    kernel='auto' (`nuts_batched_t`, every leapfrog the plain one-pass
    function with the Gaussian and t entries), at chip_smoke.py's target
    0.95: R-hat <= 1.1, few divergences, each linked mean within 5 MCSE."""
    rng = np.random.default_rng(1)
    Z = rng.multivariate_normal(np.asarray([1.0, 0.0, -1.0]), _NUTS_LA @ _NUTS_LA.T, size=20)
    prec = torch.as_tensor(np.linalg.inv(_NUTS_LA @ _NUTS_LA.T))
    Zt = torch.as_tensor(Z)

    def loglik(x):
        r = Zt - x["x"]
        return -0.5 * torch.sum((r @ prec) * r)

    tm = tbt.Model(_port(_nuts_model()), loglik=loglik, device="cpu")
    before = dict(kernels.LAUNCHES)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        draws, _, stats = tm.sample(
            torch.Generator().manual_seed(0), n_chains=8, n_warmup=150, n_samples=150,
            max_depth=6, constrained=False, target_accept=0.95,
        )
    finally:
        torch.set_num_threads(threads)
    assert kernels.LAUNCHES == before
    assert draws.shape == (150, 8, 9) and torch.isfinite(draws).all()
    assert float(diagnostics.rhat(draws).max()) <= 1.1
    assert int(stats.diverging.sum()) <= 0.01 * stats.diverging.numel()
    J = np.asarray([[2.0, 0.3], [0.3, 1.0]])
    post = np.concatenate([(_NUTS_MU + Z.sum(0)) / 21.0, [0.1, -0.3],
                           np.linalg.solve(J, [0.2, -0.1]), [0.1, -0.2]])
    np.testing.assert_array_less(np.abs(draws.mean(dim=(0, 1)).numpy() - post),
                                 5.0 * diagnostics.mcse_mean(draws))
    x = tm.constrain(draws)
    assert torch.equal(x["ln"], torch.exp(draws[..., 7:]))


# ---------------------------------------------------------------------------
# the LKJ inverse at K = 64 (a warp an element, its tiles in shared memory)
# ---------------------------------------------------------------------------


def test_lkj64_inverse_plain_matches_jax():
    """The plain LKJ(64) inverse link, which the kernel is held to on the
    card at K = 64, against the JAX package's (its jnp path: K > 16)."""
    K = 64
    y = 0.4 * np.random.default_rng(9).standard_normal((3, K * (K - 1) // 2))
    X, logJ, _, _ = klkj.lkj_inverse_plain(torch.as_tensor(y), K)
    Xj, ldj = JVecCorr().inverse_and_log_det(jnp.asarray(y))
    _close(X, Xj, dict(rtol=1e-12, atol=1e-14))
    _close(logJ, ldj, dict(rtol=1e-12, atol=0))


def test_func_transforms_hand_the_kernels_tensors_with_storage(mv_case, monkeypatch):
    """Under torch.func.jvp and torch.func.grad the derivative rules of the
    fused density reach the wrappers with plain tensors, whose data
    pointers a CUDA launch reads (a transform's wrapped tensors have none):
    the plain versions, patched to read the pointers as the launch does,
    give the unpatched results."""
    _, _, u_t, vT, dvT, _ = mv_case
    vT, dvT = torch.as_tensor(vT), torch.as_tensor(dvT)
    ref_jvp = torch.func.jvp(u_t.linked_logdensity_t, (vT,), (dvT,))[1]
    ref_grad = torch.func.grad(lambda v: u_t.linked_logdensity_t(v).sum())(vT)

    def reading(plain):
        def fn(*args):
            for a in args:
                if isinstance(a, torch.Tensor):
                    a.data_ptr()
            return plain(*args)

        return fn

    monkeypatch.setattr(tfk, "slab_jvp_plain", reading(tfb.slab_jvp_plain))
    monkeypatch.setattr(tfk, "slab_vjp_plain", reading(tfb.slab_vjp_plain))
    assert torch.equal(torch.func.jvp(u_t.linked_logdensity_t, (vT,), (dvT,))[1], ref_jvp)
    assert torch.equal(torch.func.grad(lambda v: u_t.linked_logdensity_t(v).sum())(vT), ref_grad)
