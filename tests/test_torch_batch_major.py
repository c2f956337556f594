"""The port's batch-major path against the JAX package: the LKJ log-det,
the x-only simplex inverse and the fused simplex forward link, the classic
bijector interface (Invert, inverse, Chain), and the bench model's
batch-major entry points (linked_logdensity, from_linked_vec_with_logpdf,
to_linked_vec, Model.batched_logdensity_fn).

Same numpy inputs, float64 on the CPU. Values: the JAX Pallas kernels in
interpret mode and the JAX plain paths against the port's plain versions
(what its wrappers run for a CPU tensor; the CUDA kernels are held against
those plain versions on the card by chip_smoke.py). Gradients: the port's
closed-form backward passes against torch.autograd through its plain
versions and against jax.grad of the JAX plain paths, at ordinary and at
1e10 inputs, for a contiguous (B, P) input and for the swapped view of a
transposed (P, B) state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CPU64, spec_of
from test_torch_fused import MODELS as FUSED_MODELS
from test_torch_links import GRAD_TOL, VAL_TOL, _inputs, _jax_grad, _layout, _loss
from test_torch_nuts import _jax_loglik, _jax_priors, _torch_loglik

import tpu_bijectors as tb
from tpu_bijectors import dists as jd
from tpu_bijectors.bijectors import corr as jcorr
from tpu_bijectors.bijectors import simplex as jsimplex
from tpu_bijectors.infer import Model as JModel
from tpu_bijectors.kernels.lkj import lkj_logdet_pallas
from tpu_bijectors.kernels.simplex import (
    simplex_forward_logdet_pallas,
    simplex_inverse_pallas,
)
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch import kernels
from tpu_bijectors_torch.bijectors import SimplexBijector, VecCorrBijector
from tpu_bijectors_torch.bijectors.corr import _lkj_logdet_all
from tpu_bijectors_torch.kernels.lkj import lkj_logdet, lkj_logdet_plain
from tpu_bijectors_torch.kernels.simplex import (
    simplex_forward_logdet,
    simplex_forward_logdet_plain,
    simplex_inverse,
    simplex_inverse_plain,
)

B = 24
MODEL_TOL = dict(rtol=1e-10, atol=1e-10)  # float64, other orders of summation


def _simplex_points(rng, B, K, scale):
    """Simplex points: interior Dirichlet draws, or (at the scale 1e10 of
    the states that put the inverse there) points on the simplex's faces:
    vertices and points with 2 or 3 nonzero coordinates, with dyadic
    masses so that every prefix sum is exact. The inverse's images of 1e10
    states carry 1e-32 remainders beside a prefix sum of 1, where the
    forward link is infinite in both packages."""
    if scale <= 1:
        return rng.dirichlet(np.full(K, 0.8), B)
    x = np.zeros((B, K))
    masses = ([1.0], [0.5, 0.5], [0.5, 0.25, 0.25])
    for r in range(B):
        m = masses[rng.integers(0, 3)]
        x[r, rng.choice(K, len(m), replace=False)] = m
    return x


# ---------------------------------------------------------------------------
# the LKJ log-det (#5)
# ---------------------------------------------------------------------------


def _jax_lkj_logdet_plain(chol):
    return jax.jit(jcorr._chol_logdet_jnp if chol else jcorr._vec_corr_logdet_jnp)


@pytest.mark.parametrize("chol", [False, True])
@pytest.mark.parametrize("K", [3, 5, 16])
def test_lkj_logdet_values_match_jax_kernel_and_plain(rng, K, chol):
    """The plain version in both layouts against the JAX Pallas kernel in
    interpret mode (both `pre_t` layouts) and the JAX plain path; the
    bijector's entries (batch-major and transposed) give the same."""
    y = _inputs(rng, B, K * (K - 1) // 2, 0.7)
    refs = [_jax_lkj_logdet_plain(chol)(jnp.asarray(y))]
    if K < 16:  # interpreting the unrolled K = 16 kernel takes half a minute
        refs.append(lkj_logdet_pallas(jnp.asarray(y), K, chol=chol, interpret=True))
        refs.append(
            lkj_logdet_pallas(jnp.asarray(y.T), K, chol=chol, pre_t=True, interpret=True)
        )
    for layout in ("batch", "swapped"):
        logJ, log_diag = lkj_logdet_plain(_layout(y, layout), K, chol)
        assert logJ.shape == (B,) and log_diag.shape == (B, K)
        for lr, dr in refs:
            np.testing.assert_allclose(logJ.numpy(), np.asarray(lr), **VAL_TOL)
            np.testing.assert_allclose(log_diag.numpy(), np.asarray(dr), **VAL_TOL)
    if not chol:
        yt = torch.as_tensor(y)
        ref = VecCorrBijector().inverse_and_log_det(yt)[1]
        for got in (
            VecCorrBijector().inverse_log_det_and_factor_only(yt),
            VecCorrBijector().inverse_log_det_and_factor_only_t(yt.T.contiguous()),
        ):
            np.testing.assert_allclose(got[0].numpy(), ref.numpy(), **VAL_TOL)


@pytest.mark.parametrize("chol", [False, True])
@pytest.mark.parametrize("K", [3, 5, 16])
def test_lkj_logdet_backward_matches_autograd_and_jax(rng, K, chol):
    """At ordinary and at 1e10 inputs, for both layouts."""
    P = K * (K - 1) // 2
    jg = _jax_grad(jcorr._chol_logdet_jnp if chol else jcorr._vec_corr_logdet_jnp)
    for scale in (0.7, 1e10):
        y = _inputs(rng, B, P, scale)
        cts = (rng.standard_normal(B), rng.standard_normal((B, K)))
        gy_j = jg(jnp.asarray(y), cts=cts)
        for layout in ("batch", "swapped"):
            yt = _layout(y, layout).requires_grad_(True)
            (gy,) = torch.autograd.grad(_loss(_lkj_logdet_all(yt, chol), cts), yt)
            (gy_ag,) = torch.autograd.grad(_loss(lkj_logdet_plain(yt, K, chol), cts), yt)
            assert torch.isfinite(gy).all()
            np.testing.assert_allclose(gy.numpy(), gy_ag.numpy(), **GRAD_TOL)
            np.testing.assert_allclose(gy.numpy(), np.asarray(gy_j), **GRAD_TOL)
    # one output used: the other's cotangent is skipped
    yt = torch.as_tensor(_inputs(rng, 6, P, 0.7)).requires_grad_(True)
    (g1,) = torch.autograd.grad(_lkj_logdet_all(yt, chol)[0].sum(), yt)
    (g2,) = torch.autograd.grad(_loss(_lkj_logdet_all(yt, chol), (np.ones(6), np.zeros((6, K)))), yt)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-14, atol=1e-14)


# ---------------------------------------------------------------------------
# the x-only simplex inverse (#8) and the fused forward link (#9)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [4, 16])
def test_simplex_inverse_matches_jax_kernel_and_plain(rng, K):
    for scale in (1.5, 1e10):
        y = _inputs(rng, B, K - 1, scale)
        refs = (
            simplex_inverse_pallas(jnp.asarray(y), interpret=True),
            jax.jit(jsimplex._simplex_inverse)(jnp.asarray(y)),
            jax.jit(jsimplex.SimplexBijector().inverse)(jnp.asarray(y)),
        )
        for layout in ("batch", "swapped"):
            yt = _layout(y, layout)
            x = simplex_inverse_plain(yt)
            assert torch.equal(SimplexBijector().inverse(yt), x)
            for ref in refs:
                np.testing.assert_allclose(x.numpy(), np.asarray(ref), **VAL_TOL)


@pytest.mark.parametrize("K", [4, 16])
def test_simplex_forward_logdet_matches_jax_kernel_and_plain(rng, K):
    jb = jsimplex.SimplexBijector()
    for scale in (1.0, 1e10):
        x = _simplex_points(rng, B, K, scale)
        refs = (
            simplex_forward_logdet_pallas(jnp.asarray(x), interpret=True),
            jax.jit(jsimplex._simplex_forward_logdet_jnp)(jnp.asarray(x)),
            jax.jit(jb.forward_and_log_det)(jnp.asarray(x)),
        )
        for layout in ("batch", "swapped"):
            xt = _layout(x, layout)
            y, ld = simplex_forward_logdet_plain(xt)
            y_b, ld_b = SimplexBijector().forward_and_log_det(xt)
            assert torch.equal(y_b, y) and torch.equal(ld_b, ld)
            assert torch.equal(SimplexBijector().forward(xt), y)
            for yr, lr in refs:
                np.testing.assert_allclose(y.numpy(), np.asarray(yr), **VAL_TOL)
                np.testing.assert_allclose(ld.numpy(), np.asarray(lr), **VAL_TOL)


@pytest.mark.parametrize("K", [4, 16])
def test_simplex_inverse_and_forward_backward_match_autograd_and_jax(rng, K):
    """x-only inverse: against jax.grad through the JAX scan path.
    Forward with its log-det: against jax.grad of the JAX closed-form
    forward. Both layouts, ordinary and 1e10 inputs."""
    jb = jsimplex.SimplexBijector()
    jg_inv = _jax_grad(lambda y: (jsimplex._simplex_inverse(y),))
    jg_fwd = _jax_grad(jsimplex._simplex_forward_logdet_jnp)
    for scale in (1.5, 1e10):
        y = _inputs(rng, B, K - 1, scale)
        x = _simplex_points(rng, B, K, scale)
        ct_x = (rng.standard_normal((B, K)),)
        ct_y = (rng.standard_normal((B, K - 1)), rng.standard_normal(B))
        gi_j = jg_inv(jnp.asarray(y), cts=ct_x)
        gf_j = jg_fwd(jnp.asarray(x), cts=ct_y)
        np.testing.assert_allclose(
            np.asarray(gi_j),
            np.asarray(_jax_grad(lambda v: (jb.inverse(v),))(jnp.asarray(y), cts=ct_x)),
            **GRAD_TOL,
        )
        for layout in ("batch", "swapped"):
            yt = _layout(y, layout).requires_grad_(True)
            (gi,) = torch.autograd.grad(_loss((SimplexBijector().inverse(yt),), ct_x), yt)
            (gi_ag,) = torch.autograd.grad(_loss((simplex_inverse_plain(yt),), ct_x), yt)
            xt = _layout(x, layout).requires_grad_(True)
            (gf,) = torch.autograd.grad(
                _loss(SimplexBijector().forward_and_log_det(xt), ct_y), xt
            )
            (gf_ag,) = torch.autograd.grad(_loss(simplex_forward_logdet_plain(xt), ct_y), xt)
            for got, ag, ref in ((gi, gi_ag, gi_j), (gf, gf_ag, gf_j)):
                assert torch.isfinite(got).all()
                np.testing.assert_allclose(got.numpy(), ag.numpy(), **GRAD_TOL)
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


def test_cpu_wrappers_run_plain_versions_without_launching(rng):
    before = dict(kernels.LAUNCHES)
    y = torch.as_tensor(_inputs(rng, B, 10, 1.0))
    for chol in (False, True):
        for got, ref in zip(lkj_logdet(y, 5, chol), lkj_logdet_plain(y, 5, chol)):
            assert torch.equal(got, ref)
    assert torch.equal(simplex_inverse(y), simplex_inverse_plain(y))
    x = torch.as_tensor(rng.dirichlet(np.ones(11), B))
    for got, ref in zip(simplex_forward_logdet(x), simplex_forward_logdet_plain(x)):
        assert torch.equal(got, ref)
    assert kernels.LAUNCHES == before


def test_simplex_forward_rejects_a_one_point_simplex():
    with pytest.raises(ValueError, match=">= 2"):
        SimplexBijector().forward(torch.ones(1, dtype=torch.float64))
    with pytest.raises(ValueError, match=">= 2"):
        jsimplex.SimplexBijector().forward(jnp.ones(1))


# ---------------------------------------------------------------------------
# the classic bijector interface
# ---------------------------------------------------------------------------


def _chains():
    """(port, JAX) pairs: the inverse of the Dirichlet link, and a chain
    of the LogNormal link (elementwise) after the inverse simplex link."""
    alpha = np.ones(5)
    sb = tbt.bijector(td.Dirichlet(alpha, **CPU64))
    jsb = tb.bijector(jd.Dirichlet(jnp.asarray(alpha)))
    lb = tbt.bijector(td.LogNormal(**CPU64))
    jlb = tb.bijector(jd.LogNormal())
    return {
        "inverse": (tbt.inverse(sb), tb.inverse(jsb)),
        "chain": (tbt.Chain((lb, tbt.inverse(sb))), tb.Chain((jlb, tb.inverse(jsb)))),
    }


@pytest.mark.parametrize("name", ["inverse", "chain"])
def test_invert_and_chain_match_jax_both_ways(rng, name):
    b, jb = _chains()[name]
    y = _inputs(rng, 9, 4, 1.5).reshape(3, 3, 4)
    for direction in ("forward_and_log_det", "inverse_and_log_det"):
        if direction == "inverse_and_log_det":
            y = np.asarray(jb.forward(jnp.asarray(y)))
        got = getattr(b, direction)(torch.tensor(y))
        ref = getattr(jb, direction)(jnp.asarray(y))
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **VAL_TOL)
    assert (b.event_ndims_in, b.event_ndims_out) == (jb.event_ndims_in, jb.event_ndims_out)
    assert b.forward_event_shape((4,)) == tuple(jb.forward_event_shape((4,)))
    assert b.inverse_event_shape((5,)) == tuple(jb.inverse_event_shape((5,)))
    assert tbt.inverse(tbt.inverse(b)) == b


def test_chain_rejects_too_few_dims():
    b, jb = _chains()["chain"]
    with pytest.raises(ValueError, match="event dims"):
        b.forward_and_log_det(torch.zeros((), dtype=torch.float64))
    with pytest.raises(ValueError, match="event dims"):
        jb.forward_and_log_det(jnp.zeros(()))


# ---------------------------------------------------------------------------
# the bench model's batch-major entry points
# ---------------------------------------------------------------------------


def _bench_pair(with_loglik=False):
    if with_loglik:
        priors = _jax_priors()
        port = tbt.Model(tbt.dist_from_spec(spec_of(priors), **CPU64),
                         loglik=_torch_loglik, device="cpu")
        return JModel(priors=priors, loglik=_jax_loglik), port
    priors = FUSED_MODELS["bench"]()
    port = tbt.Model(tbt.dist_from_spec(spec_of(priors), **CPU64), device="cpu")
    return JModel(priors=priors), port


@pytest.mark.parametrize("scale", [0.7, 1e10])
def test_bench_linked_logdensity_and_with_logpdf_match_jax(rng, scale):
    jm, tm = _bench_pair()
    u_j, u_t = junconstrain(jm.priors), tm.unconstrainer()
    v = scale * rng.standard_normal((17, 151))
    lp = u_t.linked_logdensity(torch.as_tensor(v))
    x, lp2 = u_t.from_linked_vec_with_logpdf(torch.as_tensor(v))
    ref = np.asarray(jax.jit(u_j.linked_logdensity)(jnp.asarray(v)))
    x_j, lp2_j = jax.jit(u_j.from_linked_vec_with_logpdf)(jnp.asarray(v))
    assert torch.isfinite(lp).all() and torch.isfinite(lp2).all()
    np.testing.assert_allclose(lp.numpy(), ref, rtol=1e-12)
    np.testing.assert_allclose(lp2.numpy(), np.asarray(lp2_j), rtol=1e-12)
    assert sorted(x) == sorted(x_j)
    for k in x_j:
        np.testing.assert_allclose(x[k].numpy(), np.asarray(x_j[k]), rtol=1e-12, atol=1e-14)
    # the composed transposed path (its LKJ leaf through the log-det of the
    # (P, B) block) and its gradient
    vT = torch.as_tensor(np.ascontiguousarray(v.T)).requires_grad_(True)
    lpt = u_t._linked_logdensity_t_children(vT)
    (gt,) = torch.autograd.grad(lpt.sum(), vT)
    jlp, jg = jax.jit(jax.value_and_grad(lambda a: jnp.sum(u_j._linked_logdensity_t_children(a))))(
        jnp.asarray(v.T)
    )
    np.testing.assert_allclose(lpt.detach().numpy(), ref, rtol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)


def test_bench_to_linked_vec_matches_jax_and_round_trips(rng):
    jm, tm = _bench_pair()
    u_j, u_t = junconstrain(jm.priors), tm.unconstrainer()
    v = 0.7 * rng.standard_normal((11, 151))
    x, ld = u_t.from_linked_vec(torch.as_tensor(v))
    v2, ld2 = u_t.to_linked_vec(x)
    v2_j, ld2_j = jax.jit(u_j.to_linked_vec)(
        {k: jnp.asarray(t.numpy()) for k, t in x.items()}
    )
    np.testing.assert_allclose(v2.numpy(), v, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ld2.numpy(), -ld.numpy(), rtol=1e-9)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ld2.numpy(), np.asarray(ld2_j), rtol=1e-10)


@pytest.mark.parametrize("with_loglik", [False, True])
def test_batched_logdensity_fn_and_grad_match_jax(rng, with_loglik):
    """Model.batched_logdensity_fn on (B, dim) states and its
    value_and_grad_fn, without and with a likelihood (the bench model, and
    the scaled-down likelihood model of test_torch_nuts.py)."""
    jm, tm = _bench_pair(with_loglik)
    v = 0.7 * rng.standard_normal((13, tm.dim()))
    f, jf = tm.batched_logdensity_fn(), jm.batched_logdensity_fn()
    lp = f(torch.as_tensor(v))
    ref, ref_g = jax.jit(jax.vmap(jax.value_and_grad(lambda a: jf(a[None])[0])))(jnp.asarray(v))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref), **MODEL_TOL)
    lp_vg, g = f.value_and_grad_fn(torch.as_tensor(v))
    assert not lp_vg.requires_grad and g.shape == v.shape
    np.testing.assert_allclose(lp_vg.numpy(), np.asarray(ref), **MODEL_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), **MODEL_TOL)
    # the transposed density of the same states
    np.testing.assert_allclose(
        tm.batched_logdensity_t_fn()(torch.as_tensor(v.T)).numpy(), lp.numpy(), **MODEL_TOL
    )
