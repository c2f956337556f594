"""The port's positive-definite links and Wishart families against the JAX
package.

Same numpy inputs, float64 on the CPU, K in {1, 3, 5}. Values: the JAX
Pallas PD kernels in interpret mode (both modes, both layouts) and the
JAX plain paths against the port's plain versions (what its wrappers run
for a CPU tensor; the CUDA kernels are held against those plain versions
on the card by chip_smoke.py). Gradients: the port's closed-form backward
passes against jax.grad of the JAX plain paths. The Wishart families'
densities and hooks, the whole-model value, gradient and vector-Jacobian
product with PD loop entries against the JAX package's mega kernels in
interpret mode, `kernel='auto'`'s choice, and a short NUTS run on a
conjugate Wishart model against its known posterior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import ATOL, CPU64, RTOL, spec_of
from test_torch_links import GRAD_TOL, VAL_TOL
from test_torch_nuts import _picked

from tpu_bijectors import dists as jd
from tpu_bijectors.bijectors import pd as jpd
from tpu_bijectors.infer import Model as JModel
from tpu_bijectors.kernels.pd import (
    pd_inverse_pallas,
    pd_logdensity_pallas,
    pd_trace_grad_pallas,
)
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import diagnostics, kernels
from tpu_bijectors_torch.bijectors import CholeskyVecBijector, PDBijector, PDVecBijector
from tpu_bijectors_torch.bijectors import pd as tpd
from tpu_bijectors_torch.kernels import pd as kpd
from tpu_bijectors_torch.vectorize import fused_kernel as tfk
from tpu_bijectors_torch.vectorize.fused_plan import _plan

KS = [1, 3, 5]
B = 24


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _y(rng, K, scale=0.5, off_scale=None):
    """y (B, P): scale * N(0, 1) on every slot, or off_scale * N(0, 1) off
    the diagonal (the diagonal slots stay at scale: exp of a 1e10 diagonal
    overflows in either package)."""
    P = K * (K + 1) // 2
    y = scale * rng.standard_normal((B, P))
    if off_scale is not None:
        diag = [r * (r + 1) // 2 + r for r in range(K)]
        off = np.setdiff1d(np.arange(P), diag)
        y[:, off] = off_scale * rng.standard_normal((B, off.size))
    return y


def _layout(y, layout):
    """A contiguous (B, P) tensor, or the swapped view yT.T of a contiguous
    (P, B) tensor (what the transposed state gives; at K = 1 the two
    coincide)."""
    if layout == "swapped":
        return torch.as_tensor(np.ascontiguousarray(y.T)).T
    return torch.as_tensor(y)


def _C(rng, K, mode):
    """S^-1 of a random SPD S (dot mode) or the lower factor of a random
    SPD Psi (solve mode), float64."""
    A = rng.standard_normal((K, K))
    S = A @ A.T + K * np.eye(K)
    return np.linalg.inv(S) if mode == "dot" else np.linalg.cholesky(S)


def _close(got, ref, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)


# ---------------------------------------------------------------------------
# the three kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", KS)
def test_pd_inverse_plain_matches_jax_kernel(rng, K):
    y = _y(rng, K)
    ref = pd_inverse_pallas(jnp.asarray(y), K, interpret=True)
    for layout in ("batch", "swapped"):
        for got, r in zip(kpd.pd_inverse_plain(_layout(y, layout), K), ref):
            _close(got, r, VAL_TOL)


@pytest.mark.parametrize("mode", kpd.MODES)
@pytest.mark.parametrize("K", KS)
def test_pd_logdensity_plain_matches_jax_kernel(rng, K, mode):
    y, C = _y(rng, K), _C(rng, K, mode)
    for layout, pre_t in (("batch", False), ("swapped", True)):
        yj = jnp.asarray(y.T if pre_t else y)
        ref = pd_logdensity_pallas(yj, K, jnp.asarray(C), mode, pre_t=pre_t, interpret=True)
        got = kpd.pd_logdensity_plain(_layout(y, layout), K, torch.as_tensor(C), mode)
        for g, r in zip(got, ref):
            _close(g, r, VAL_TOL)


@pytest.mark.parametrize("mode", kpd.MODES)
@pytest.mark.parametrize("K", KS)
def test_pd_trace_grad_plain_matches_jax_kernel(rng, K, mode):
    y, C = _y(rng, K), _C(rng, K, mode)
    for layout, pre_t in (("batch", False), ("swapped", True)):
        yj = jnp.asarray(y.T if pre_t else y)
        ref = pd_trace_grad_pallas(yj, K, jnp.asarray(C), mode, pre_t=pre_t, interpret=True)
        got = kpd.pd_trace_grad_plain(_layout(y, layout), K, torch.as_tensor(C), mode)
        _close(got.T if pre_t else got, ref, VAL_TOL)


def test_dot_mode_symmetrises_c(rng):
    """In dot mode C enters as (C + C') / 2, so the trace is tr(C X) and its
    gradient that of the JAX package's composed tr(C X) for any C."""
    K = 3
    y, C = _y(rng, K), rng.standard_normal((K, K))
    got = kpd.pd_logdensity_plain(torch.as_tensor(y), K, torch.as_tensor(C), "dot")[2]
    ref = jpd._pd_logdensity_jnp(jnp.asarray(y), jnp.asarray(C), "dot")[2]
    _close(got, ref, VAL_TOL)
    g = kpd.pd_trace_grad_plain(torch.as_tensor(y), K, torch.as_tensor(C), "dot")
    _close(g, jpd._tr_grad_jnp(jnp.asarray(y), jnp.asarray(C), "dot"), GRAD_TOL)


def test_cpu_wrappers_run_plain_versions_without_launching(rng):
    K = 3
    y, C = torch.as_tensor(_y(rng, K)), torch.as_tensor(_C(rng, K, "solve"))
    before = dict(kernels.LAUNCHES)
    for got, ref in zip(kpd.pd_inverse(y, K), kpd.pd_inverse_plain(y, K)):
        assert torch.equal(got, ref)
    for mode in kpd.MODES:
        for got, ref in zip(kpd.pd_logdensity(y, K, C, mode),
                            kpd.pd_logdensity_plain(y, K, C, mode)):
            assert torch.equal(got, ref)
        assert torch.equal(kpd.pd_trace_grad(y, K, C, mode),
                           kpd.pd_trace_grad_plain(y, K, C, mode))
    assert kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# the autograd Functions' closed-form backward passes against jax.grad
# ---------------------------------------------------------------------------


def _grad(fn, y, cts):
    v = torch.as_tensor(y).requires_grad_(True)
    loss = sum(torch.sum(o * torch.as_tensor(c)) for o, c in zip(fn(v), cts))
    return torch.autograd.grad(loss, v)[0]


def _jgrad(fn, y, cts):
    def loss(v):
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(fn(v), cts))

    return jax.grad(loss)(jnp.asarray(y))


@pytest.mark.parametrize("off_scale", [None, 1e10])
@pytest.mark.parametrize("K", KS)
def test_pd_inverse_backward_matches_jax_grad(rng, K, off_scale):
    """(X, logJ, L) of y through `_pd_inverse_all` against jax.grad of
    `_pd_inverse_all_jnp`; also with the off-diagonal slots at 1e10."""
    y = _y(rng, K, off_scale=off_scale)
    cts = (rng.standard_normal((B, K, K)), rng.standard_normal(B), rng.standard_normal((B, K, K)))
    got = _grad(tpd._pd_inverse_all, y, cts)
    ref = _jgrad(jpd._pd_inverse_all_jnp, y, cts)
    assert torch.isfinite(got).all()
    _close(got, ref, GRAD_TOL)


@pytest.mark.parametrize("off_scale", [None, 1e10])
@pytest.mark.parametrize("mode", kpd.MODES)
@pytest.mark.parametrize("K", KS)
def test_pd_logdensity_backward_matches_jax_grad(rng, K, mode, off_scale):
    """(logJ, sum y_rr, trace) through `_pd_logdensity` (the affine slopes
    plus the trace's cotangent times `pd_trace_grad`) against jax.grad of
    `_pd_logdensity_jnp`, for a contiguous y and the swapped view; also
    with the off-diagonal slots at 1e10."""
    y, C = _y(rng, K, off_scale=off_scale), _C(rng, K, mode)
    cts = tuple(rng.standard_normal(B) for _ in range(3))
    ref = _jgrad(lambda v: jpd._pd_logdensity_jnp(v, jnp.asarray(C), mode), y, cts)
    for layout in ("batch", "swapped"):
        v = _layout(y, layout).requires_grad_(True)
        outs = tpd._pd_logdensity(v, K, torch.as_tensor(C), mode)
        loss = sum(torch.sum(o * torch.as_tensor(c)) for o, c in zip(outs, cts))
        (got,) = torch.autograd.grad(loss, v)
        assert torch.isfinite(got).all()
        _close(got, ref, GRAD_TOL)


def test_parameter_gradients_raise():
    """C's gradient through the PD log-density, which raised until the
    Function passed it (the plain version's): against jax.grad of the JAX
    package's jnp composition, in both modes. The test keeps its name."""
    K = 2
    y = np.asarray([[0.3, -0.2, 0.1], [0.5, 0.4, -0.3]])
    C = np.asarray([[1.5, 0.2], [0.2, 0.8]])
    w = np.asarray([[0.7, -1.1, 0.4], [0.2, 0.9, -0.5]])
    for mode in ("dot", "solve"):
        Cm = np.linalg.cholesky(C) if mode == "solve" else C
        ref = jax.grad(lambda c: sum(jnp.sum(jnp.asarray(w[:, i]) * o) for i, o in enumerate(
            jpd._pd_logdensity_jnp(jnp.asarray(y), c, mode))))(jnp.asarray(Cm))
        Ct = torch.tensor(Cm, requires_grad=True)
        outs = tpd._pd_logdensity(torch.as_tensor(y), K, Ct, mode)
        (got,) = torch.autograd.grad(sum(torch.sum(torch.as_tensor(w[:, i]) * o)
                                         for i, o in enumerate(outs)), Ct)
        _close(got, np.asarray(ref), GRAD_TOL)


# ---------------------------------------------------------------------------
# the bijectors and the Wishart families
# ---------------------------------------------------------------------------


def _spd(rng, n, K):
    A = rng.standard_normal((n, K, K))
    return A @ np.swapaxes(A, -1, -2) + K * np.eye(K)


@pytest.mark.parametrize("K", KS)
def test_bijectors_match_jax(rng, K):
    X = _spd(rng, 6, K)
    for tb_, jb in ((PDVecBijector(), jpd.PDVecBijector()), (PDBijector(), jpd.PDBijector())):
        y, ld = tb_.forward_and_log_det(torch.as_tensor(X))
        yr, ldr = jb.forward_and_log_det(jnp.asarray(X))
        _close(y, yr, GRAD_TOL)  # another Cholesky: 1e-10
        _close(ld, ldr, GRAD_TOL)
        Xb, ldb = tb_.inverse_and_log_det(y)
        Xr, ldbr = jb.inverse_and_log_det(jnp.asarray(y.numpy()))
        _close(Xb, Xr, VAL_TOL)
        _close(ldb, ldbr, VAL_TOL)
        _close(Xb, X, GRAD_TOL)
    L = np.linalg.cholesky(X)
    y, ld = CholeskyVecBijector().forward_and_log_det(torch.as_tensor(L))
    yr, ldr = jpd.CholeskyVecBijector().forward_and_log_det(jnp.asarray(L))
    _close(y, yr, VAL_TOL)
    _close(ld, ldr, VAL_TOL)
    Lb, ldb = CholeskyVecBijector().inverse_and_log_det(y)
    _close(Lb, L, VAL_TOL)
    _close(ldb, -ld, VAL_TOL)
    # leading axes flatten into the kernel's batch
    yv = torch.as_tensor(_y(rng, K).reshape(4, 6, -1))
    Xv, ldv = PDVecBijector().inverse_and_log_det(yv)
    Xr, ldr = jpd.PDVecBijector().inverse_and_log_det(jnp.asarray(yv.numpy()))
    _close(Xv, Xr, VAL_TOL)
    _close(ldv, ldr, VAL_TOL)


FAMILIES = {
    "wishart": lambda K: jd.Wishart(K + 4.0, 2.0 * jnp.eye(K, dtype=jnp.float64)),
    "invwishart": lambda K: jd.InverseWishart(K + 4.0, 2.0 * jnp.eye(K, dtype=jnp.float64)),
}


def _family(rng, name, K):
    """A JAX family with a random scale and its port twin."""
    A = rng.standard_normal((K, K))
    S = A @ A.T + K * np.eye(K)
    cls = jd.Wishart if name == "wishart" else jd.InverseWishart
    jdist = cls(K + 2.5, jnp.asarray(S))
    return jdist, tbt.dist_from_spec(spec_of(jdist), **CPU64)


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("K", KS)
def test_family_densities_match_jax(rng, name, K):
    """logpdf, logpdf_from_factor (with and without x) and both fused hooks
    (against the JAX package's composed linked density: its own hooks
    decline off the TPU)."""
    jdist, tdist = _family(rng, name, K)
    X = _spd(rng, B, K)
    _close(tdist.logpdf(torch.as_tensor(X)), jdist.logpdf(jnp.asarray(X)), GRAD_TOL)
    L = np.linalg.cholesky(X)
    for x in (None, X):
        xt = None if x is None else torch.as_tensor(x)
        xj = None if x is None else jnp.asarray(x)
        _close(tdist.logpdf_from_factor(torch.as_tensor(L), xt),
               jdist.logpdf_from_factor(jnp.asarray(L), xj), GRAD_TOL)
    y = _y(rng, K)
    uj = junconstrain(jdist)
    ref = uj.linked_logdensity(jnp.asarray(y))
    b = tbt.bijector(tdist)
    _, got = tdist.fused_linked_logdensity(b, torch.as_tensor(y), want_x=False)
    _close(got, ref, VAL_TOL)
    # with x wanted, x comes from the inverse link beside the fused density
    x_h, lp_h = tdist.fused_linked_logdensity(b, torch.as_tensor(y))
    _close(x_h, uj.from_linked_vec(jnp.asarray(y))[0], VAL_TOL)
    _close(lp_h, ref, VAL_TOL)
    _close(tdist.fused_linked_logdensity_t(b, torch.as_tensor(np.ascontiguousarray(y.T))),
           ref, VAL_TOL)
    ut = tbt.unconstrain(tdist, device="cpu")
    x, lp = ut.from_linked_vec_with_logpdf(torch.as_tensor(y))
    xr, lpr = uj.from_linked_vec_with_logpdf(jnp.asarray(y))
    _close(x, xr, VAL_TOL)
    _close(lp, lpr, VAL_TOL)
    _close(ut.linked_logdensity(torch.as_tensor(y)), ref, VAL_TOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_sample_moments(name):
    """Bartlett draws from an explicit generator: the sample mean of 20000
    draws against E[X] = df S (Wishart) or Psi / (df - K - 1)
    (InverseWishart), within 5 standard errors per entry."""
    K, df = 3, 9.0
    S = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, -0.2], [0.0, -0.2, 0.5]])
    cls = tbt.dists.Wishart if name == "wishart" else tbt.dists.InverseWishart
    d = cls(df, S, **CPU64)
    X = d.sample(torch.Generator().manual_seed(0), (20000,))
    assert X.shape == (20000, K, K)
    assert torch.allclose(X, X.transpose(-1, -2))
    assert bool((torch.linalg.eigvalsh(X) > 0).all())
    mean = df * S if name == "wishart" else S / (df - K - 1.0)
    se = X.std(0) / np.sqrt(X.shape[0])
    assert bool(((X.mean(0) - torch.as_tensor(mean)).abs() <= 5.0 * se).all())


# ---------------------------------------------------------------------------
# the whole-model functions with PD loop entries
# ---------------------------------------------------------------------------

MODELS = {
    # tests/test_fused_logdensity.py:21-22, 33
    "wishart": lambda: jd.NamedProduct.of(W=jd.Wishart(9.0, 2.0 * jnp.eye(5, dtype=jnp.float64))),
    "invwishart": lambda: jd.NamedProduct.of(
        W=jd.InverseWishart(9.0, 2.0 * jnp.eye(5, dtype=jnp.float64))
    ),
    "iid_wishart": lambda: jd.NamedProduct.of(
        W=jd.IIDProduct(jd.Wishart(7.0, jnp.eye(3, dtype=jnp.float64)), 3)
    ),
    # tests/test_transposed_layout.py:35-36, with slab rows around them
    "matrixy": lambda: jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.0, 2.0), 2),
        wish=jd.Wishart(7.0, jnp.eye(4)),
        w=jd.Dirichlet(jnp.ones(4)),
        iwish=jd.InverseWishart(7.0, jnp.eye(4)),
    ),
    # tools/mega_probe.py's pdonly at K = 3, and its solve-mode twin
    "pdonly": lambda: jd.NamedProduct.of(
        W=jd.Wishart(5.0, jnp.eye(3)), m=jd.IIDProduct(jd.Normal(0.0, 1.0), 2)
    ),
    "pdonly_iw": lambda: jd.NamedProduct.of(
        W=jd.InverseWishart(5.0, jnp.eye(3)), m=jd.IIDProduct(jd.Normal(0.0, 1.0), 2)
    ),
    "k1": lambda: jd.NamedProduct.of(W=jd.Wishart(3.0, 2.0 * jnp.eye(1)),
                                     V=jd.InverseWishart(3.0, jnp.eye(1))),
}


def _pair(name):
    d = MODELS[name]()
    return junconstrain(d), tbt.unconstrain(tbt.dist_from_spec(spec_of(d), **CPU64), device="cpu")


def _state(rng, dim):
    return 0.5 * rng.standard_normal((dim, 16))


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_value_matches_jax_kernel(rng, name):
    u_j, u_t = _pair(name)
    assert _plan(u_t) is not None
    vT = _state(rng, u_t.linked_vec_length)
    ref = np.asarray(jfk.mega_logdensity_t(u_j, jnp.asarray(vT), interpret=True))
    _close(u_t.linked_logdensity_t(torch.as_tensor(vT)), ref, dict(rtol=RTOL, atol=ATOL))
    # and the composed per-leaf path (the PD log-density hooks)
    _close(u_t._linked_logdensity_t_children(torch.as_tensor(vT)), ref, dict(rtol=RTOL, atol=ATOL))


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_value_and_grad_matches_jax_kernel(rng, name):
    u_j, u_t = _pair(name)
    vT = _state(rng, u_t.linked_vec_length)
    ref_lp, ref_g = jfk.mega_value_and_grad_t(u_j, jnp.asarray(vT), interpret=True)
    lp, g = tfk.mega_value_and_grad_t(u_t, torch.as_tensor(vT))
    _close(lp, ref_lp, dict(rtol=RTOL, atol=ATOL))
    _close(g, ref_g, dict(rtol=RTOL, atol=ATOL))


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_autograd_matches_jax_vjp_kernel(rng, name):
    u_j, u_t = _pair(name)
    vT = _state(rng, u_t.linked_vec_length)
    ct = rng.standard_normal(vT.shape[1])
    ref = np.asarray(jfk.mega_vjp_t(u_j, jnp.asarray(vT), jnp.asarray(ct), interpret=True))
    v = torch.as_tensor(vT).requires_grad_(True)
    (g,) = torch.autograd.grad(u_t.linked_logdensity_t(v), v, torch.as_tensor(ct))
    _close(g, ref, dict(rtol=RTOL, atol=ATOL))
    # the composed path's autograd through the PD hooks' closed forms
    v = torch.as_tensor(vT).requires_grad_(True)
    (g,) = torch.autograd.grad(u_t._linked_logdensity_t_children(v), v, torch.as_tensor(ct))
    _close(g, ref, GRAD_TOL)


def test_prep_packs_loop_entries_once_per_parameter_block():
    """The IID copies of a Wishart share one parameter block; the loop rows
    are not slab-owned."""
    _, u_t = _pair("iid_wishart")
    cf, loops, c0sum = tfk._prep(u_t, torch.zeros((18, 2), dtype=torch.float64))
    assert [e[:3] for e in loops.entries] == [(1, 0, 3), (1, 6, 3), (1, 12, 3)]
    assert {e[3] for e in loops.entries} == {0} and loops.prm.numel() == 11
    assert loops.kmax == 3 and loops.ent.dtype == torch.int32
    assert not bool(cf.any()) and float(c0sum) == 0.0


def test_leaf_beyond_the_kernels_k_has_no_plan(rng):
    """K = 17 > MAX_K: no loop entry (the JAX package's plan declines too),
    a CPU state takes the composed path, whose hook declines and whose
    inverse is the plain version (the card raises there:
    `test_pd_inverse_beyond_the_kernels_k_raises_off_the_cpu`)."""
    K = 17
    d = tbt.dists.Wishart(K + 2.0, np.eye(K), **CPU64)
    u = tbt.unconstrain(tbt.dists.NamedProduct.of(W=d), device="cpu")
    assert _plan(u) is None
    assert d.fused_linked_logdensity(tbt.bijector(d), torch.zeros((1, 153), dtype=torch.float64),
                                     want_x=False) is None
    y = 0.1 * rng.standard_normal((2, K * (K + 1) // 2))
    x, lp = u.from_linked_vec_with_logpdf(torch.as_tensor(y))
    ld = kpd.pd_inverse_plain(torch.as_tensor(y), K)[1]
    _close(lp, d.logpdf(x["W"]) + ld, GRAD_TOL)
    with pytest.raises(NotImplementedError, match="Wishart"):
        tfk._prep(u, torch.as_tensor(np.ascontiguousarray(y.T)))


@pytest.mark.parametrize("name", ["pdonly", "pdonly_iw"])
def test_auto_picks_nuts_batched_t_for_pd_models(monkeypatch, name):
    """With a fused plan, kernel='auto' takes the transposed `nuts_batched_t`
    for both PD models, as the JAX package does on its accelerator (on the
    CPU the JAX package takes `nuts_batched`)."""
    jm = JModel(priors=MODELS[name](), loglik=None)
    tm = tbt.Model(tbt.dist_from_spec(spec_of(MODELS[name]()), **CPU64), device="cpu")
    assert _picked(monkeypatch, tm, jm) == ["nuts_batched_t", "nuts_batched"]


def test_pd_inverse_beyond_the_kernels_k_raises_off_the_cpu():
    """K = 17 > MAX_K off the CPU: the inverse link raises, naming the
    limit, through the bijector and the leaf's composed density alike
    (nothing runs the plain version on a device)."""
    K = 17
    y = torch.zeros((2, K * (K + 1) // 2), device="meta")
    b = PDVecBijector()
    for call in (b.inverse_and_log_det, b.inverse_and_log_det_with_factor, b.inverse):
        with pytest.raises(NotImplementedError, match=f"K <= {kpd.MAX_K}; got K = 17"):
            call(y)


# ---------------------------------------------------------------------------
# a short NUTS run on a conjugate Wishart model
# ---------------------------------------------------------------------------


def test_nuts_recovers_the_conjugate_wishart_posterior():
    """pdonly at K = 3 with 40 observations z ~ N(0, Sigma) and
    loglik = (n / 2) log det W - tr(W Z'Z) / 2 (W the precision): the
    posterior of W is Wishart(5 + n, (I + Z'Z)^-1), so E[W_ii] =
    (5 + n) [(I + Z'Z)^-1]_ii, and m stays N(0, 1). 8 chains, 150 warmup
    and 150 draws through kernel='auto' (`nuts_batched_t`, the PD loop
    entry for the prior, the PD inverse for the likelihood), at
    chip_smoke.py's target acceptance of 0.95 (at 0.8 one chain of this
    seed strands where L_00 ~ e^-3 and diverges at every transition):
    R-hat <= 1.1, few divergences, each mean within 5 MCSE."""
    rng = np.random.default_rng(1)
    K, n = 3, 40
    A = rng.standard_normal((K, K))
    Sigma = A @ A.T + np.eye(K)
    Z = rng.multivariate_normal(np.zeros(K), Sigma, size=n)
    ZtZ = torch.as_tensor(Z.T @ Z)
    priors = tbt.dist_from_spec(spec_of(MODELS["pdonly"]()), **CPU64)

    def loglik(x):
        W = x["W"]
        return 0.5 * n * torch.linalg.slogdet(W)[1] - 0.5 * torch.sum(W * ZtZ)

    tm = tbt.Model(priors, loglik=loglik, device="cpu")
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
    assert float(diagnostics.rhat(draws).max()) <= 1.1
    assert int(stats.diverging.sum()) <= 0.01 * stats.diverging.numel()
    x = tm.constrain(draws)
    post = (5.0 + n) * np.diag(np.linalg.inv(np.eye(K) + Z.T @ Z))
    W = torch.diagonal(x["W"], dim1=-2, dim2=-1)
    np.testing.assert_array_less(np.abs(W.mean(dim=(0, 1)).numpy() - post),
                                 5.0 * diagnostics.mcse_mean(W))
    np.testing.assert_array_less(np.abs(x["m"].mean(dim=(0, 1)).numpy()),
                                 5.0 * diagnostics.mcse_mean(x["m"]))
