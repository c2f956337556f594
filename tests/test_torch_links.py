"""The port's inverse links (stick-breaking simplex, LKJ) against the JAX
package: values and gradients.

Same numpy inputs, float64 on the CPU. Values: the JAX Pallas kernels in
interpret mode and the JAX plain paths against the port's plain versions
(what its wrappers run for a CPU tensor; the CUDA kernels are held
against those plain versions on the card by chip_smoke.py). Gradients: the
port's closed-form backward against torch.autograd through its plain
version and against jax.grad of the JAX function, at ordinary and at 1e10
inputs, for a contiguous (B, P) input and for the swapped view of a
transposed (P, B) state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bijectors.bijectors import corr as jcorr
from tpu_bijectors.bijectors import simplex as jsimplex
from tpu_bijectors.kernels.lkj import lkj_inverse_pallas
from tpu_bijectors.kernels.simplex import (
    simplex_inverse_logdet_pallas,
    simplex_inverse_logdet_wlog_pallas,
)

from tpu_bijectors_torch import kernels
from tpu_bijectors_torch.bijectors import SimplexBijector, VecCorrBijector
from tpu_bijectors_torch.bijectors.corr import _vec_corr_inverse_all
from tpu_bijectors_torch.bijectors.simplex import _simplex_inverse_logdet_wlog
from tpu_bijectors_torch.kernels.lkj import lkj_inverse, lkj_inverse_plain
from tpu_bijectors_torch.kernels.simplex import (
    simplex_inverse_logdet,
    simplex_inverse_logdet_plain,
)

VAL_TOL = dict(rtol=1e-12, atol=1e-12)  # float64, the same algebra
GRAD_TOL = dict(rtol=1e-10, atol=1e-10)  # float64, another order of operations
B = 24


def _inputs(rng, B, P, scale):
    """y (B, P): scale * N(0, 1); at 1e10 every fourth element is exactly
    +-1e10 and one row is all zeros (ties of the clamps and maxima)."""
    y = scale * rng.standard_normal((B, P))
    if scale > 1:
        y[::4] = np.sign(y[::4]) * scale
        y[1] = 0.0
    return y


def _layout(y, layout):
    """The port's input: a contiguous (B, P) tensor, or the swapped view
    yT.T of a contiguous (P, B) tensor (what the transposed state gives)."""
    t = torch.as_tensor(y)
    if layout == "swapped":
        t = torch.as_tensor(np.ascontiguousarray(y.T)).T
        assert not t.is_contiguous()
    return t


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [3, 5, 16])
def test_simplex_values_match_jax_kernel_and_plain(rng, K):
    y = _inputs(rng, B, K - 1, 1.5)
    am1 = rng.standard_normal(K)
    xj, ldj = simplex_inverse_logdet_pallas(jnp.asarray(y), interpret=True)
    xw, ldw, wlj = simplex_inverse_logdet_wlog_pallas(
        jnp.asarray(y), jnp.asarray(am1), interpret=True
    )
    xp, ldp, wlp = jax.jit(jsimplex._simplex_inverse_logdet_wlog_jnp)(
        jnp.asarray(y), jnp.asarray(am1)
    )
    for layout in ("batch", "swapped"):
        x, ld, wl = simplex_inverse_logdet_plain(_layout(y, layout), torch.as_tensor(am1))
        for ref in ((xj, ldj, None), (xw, ldw, wlj), (xp, ldp, wlp)):
            np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), **VAL_TOL)
            np.testing.assert_allclose(ld.numpy(), np.asarray(ref[1]), **VAL_TOL)
            if ref[2] is not None:
                np.testing.assert_allclose(wl.numpy(), np.asarray(ref[2]), **VAL_TOL)


@pytest.mark.parametrize("K", [3, 5, 16])
def test_lkj_values_match_jax_kernel_and_plain(rng, K):
    y = _inputs(rng, B, K * (K - 1) // 2, 0.7)
    refs = [jax.jit(jcorr._vec_corr_inverse_all_jnp)(jnp.asarray(y))]
    if K < 16:  # interpreting the unrolled K = 16 kernel takes half a minute
        refs.append(lkj_inverse_pallas(jnp.asarray(y), K, interpret=True))
    for layout in ("batch", "swapped"):
        X, logJ, log_diag, W = lkj_inverse_plain(_layout(y, layout), K, want_w=True)
        assert torch.equal(X, W.transpose(-1, -2) @ W)
        for Xr, lr, dr in refs:
            np.testing.assert_allclose(X.numpy(), np.asarray(Xr), **VAL_TOL)
            np.testing.assert_allclose(logJ.numpy(), np.asarray(lr), **VAL_TOL)
            np.testing.assert_allclose(log_diag.numpy(), np.asarray(dr), **VAL_TOL)


@pytest.mark.parametrize("scale", [1.0, 1e10])
def test_bijector_inverses_match_jax_over_leading_axes(rng, scale):
    """SimplexBijector / VecCorrBijector.inverse_and_log_det and the wlog
    entry flatten any leading axes into the batch: (3, 4, P) inputs give
    the per-element results, finite at 1e10."""
    ys = _inputs(rng, 12, 4, scale).reshape(3, 4, 4)
    yc = _inputs(rng, 12, 10, scale).reshape(3, 4, 10)
    am1 = rng.standard_normal(5)
    x, ld = SimplexBijector().inverse_and_log_det(torch.as_tensor(ys))
    xr, ldr = jax.jit(jsimplex.SimplexBijector().inverse_and_log_det)(jnp.asarray(ys))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), **VAL_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldr), **VAL_TOL)
    xn, ldn, wl = _simplex_inverse_logdet_wlog(torch.as_tensor(ys), torch.as_tensor(am1), False)
    assert xn is None and torch.equal(ldn, ld)
    wr = jax.jit(jsimplex._simplex_inverse_logdet_wlog_jnp)(jnp.asarray(ys), jnp.asarray(am1))[2]
    np.testing.assert_allclose(wl.numpy(), np.asarray(wr), **VAL_TOL)
    X, logJ = VecCorrBijector().inverse_and_log_det(torch.as_tensor(yc))
    Xr, lr = jax.jit(jcorr.VecCorrBijector().inverse_and_log_det)(jnp.asarray(yc))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xr), **VAL_TOL)
    np.testing.assert_allclose(logJ.numpy(), np.asarray(lr), **VAL_TOL)
    for t in (x, ld, wl, X, logJ):
        assert torch.isfinite(t).all()


def test_cpu_wrappers_run_plain_versions_without_launching(rng):
    before = dict(kernels.LAUNCHES)
    y = torch.as_tensor(_inputs(rng, B, 10, 1.0))
    am1 = torch.as_tensor(rng.standard_normal(11))
    for got, ref in zip(simplex_inverse_logdet(y, am1), simplex_inverse_logdet_plain(y, am1)):
        assert torch.equal(got, ref)
    for got, ref in zip(lkj_inverse(y, 5, True), lkj_inverse_plain(y, 5, True)):
        assert torch.equal(got, ref)
    assert kernels.LAUNCHES == before


def test_lkj_inverse_beyond_the_kernels_k_raises_off_the_cpu(monkeypatch):
    """K = 338 > MAX_K off the CPU: the wrapper and VecCorrBijector's
    inverse raise, naming the limit, and no plain version runs there; on
    the CPU the plain version still serves that K."""
    from tpu_bijectors_torch.kernels import lkj as klkj

    K = klkj.MAX_K + 1
    assert K == 338
    y = torch.zeros((2, K * (K - 1) // 2), device="meta")

    def no_plain(*args, **kw):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(klkj, "lkj_inverse_plain", no_plain)
    match = f"K <= {klkj.MAX_K}; got K = 338"
    with pytest.raises(NotImplementedError, match=match):
        klkj.lkj_inverse(y, K, want_w=True)
    b = VecCorrBijector()
    for call in (b.inverse_and_log_det, b.inverse):
        with pytest.raises(NotImplementedError, match=match):
            call(y)
    monkeypatch.undo()
    X, logJ, _, _ = lkj_inverse(torch.zeros((1, K * (K - 1) // 2), dtype=torch.float64), K)
    assert torch.equal(X[0], torch.eye(K, dtype=torch.float64))
    assert float(logJ[0]) == 0.0


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _grads(fn, y, cts):
    """d sum_i <ct_i, out_i> / dy through `fn` (torch), in y's layout."""
    v = y.detach().requires_grad_(True)
    outs = fn(v)
    loss = sum(torch.sum(o * torch.as_tensor(c)) for o, c in zip(outs, cts))
    return torch.autograd.grad(loss, v)


def _loss(outs, cts):
    return sum(torch.sum(o * torch.as_tensor(c)) for o, c in zip(outs, cts))


def _jax_grad(fn, argnums=0):
    """jax.grad of sum_i <ct_i, fn(*args)_i>, jitted once per shape (the
    cotangents are arguments)."""

    def loss(*a, cts):
        return sum(jnp.sum(o * c) for o, c in zip(fn(*a), cts))

    return jax.jit(jax.grad(loss, argnums))


@pytest.mark.parametrize("K", [3, 5, 16])
def test_simplex_backward_matches_autograd_and_jax(rng, K):
    """At ordinary and at 1e10 inputs, for both layouts; gradients in y and
    in the weights am1."""
    jg_wlog = _jax_grad(jsimplex.simplex_inverse_logdet_wlog, (0, 1))
    # the bijector entry (x, ld), against jax.grad through the JAX scan path
    jg_bij = _jax_grad(jsimplex.SimplexBijector().inverse_and_log_det)
    for scale in (1.5, 1e10):
        y = _inputs(rng, B, K - 1, scale)
        am1 = rng.standard_normal(K)
        cts = (rng.standard_normal((B, K)), rng.standard_normal(B), rng.standard_normal(B))
        gy_j, ga_j = jg_wlog(jnp.asarray(y), jnp.asarray(am1), cts=cts)
        g_bj = jg_bij(jnp.asarray(y), cts=cts[:2])
        for layout in ("batch", "swapped"):
            yt = _layout(y, layout).requires_grad_(True)
            at = torch.as_tensor(am1).requires_grad_(True)
            gy, ga = torch.autograd.grad(
                _loss(_simplex_inverse_logdet_wlog(yt, at), cts), (yt, at)
            )
            gy_ag, ga_ag = torch.autograd.grad(
                _loss(simplex_inverse_logdet_plain(yt, at), cts), (yt, at)
            )
            for got, ref in ((gy, gy_ag), (gy, gy_j), (ga, ga_ag), (ga, ga_j)):
                assert torch.isfinite(got).all()
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)
            (g_b,) = torch.autograd.grad(
                _loss(SimplexBijector().inverse_and_log_det(yt), cts[:2]), yt
            )
            np.testing.assert_allclose(g_b.numpy(), np.asarray(g_bj), **GRAD_TOL)


@pytest.mark.parametrize("K", [3, 5, 16])
def test_lkj_backward_matches_autograd_and_jax(rng, K):
    """At ordinary and at 1e10 inputs, for both layouts."""
    P = K * (K - 1) // 2
    jg = _jax_grad(jcorr._vec_corr_inverse_all_jnp)
    for scale in (0.7, 1e10):
        y = _inputs(rng, B, P, scale)
        cts = (rng.standard_normal((B, K, K)), rng.standard_normal(B),
               rng.standard_normal((B, K)))
        gy_j = jg(jnp.asarray(y), cts=cts)
        for layout in ("batch", "swapped"):
            yt = _layout(y, layout)
            (gy,) = _grads(_vec_corr_inverse_all, yt, cts)
            (gy_ag,) = _grads(lambda v: lkj_inverse_plain(v, K)[:3], yt, cts)
            assert torch.isfinite(gy).all()
            np.testing.assert_allclose(gy.numpy(), gy_ag.numpy(), **GRAD_TOL)
            np.testing.assert_allclose(gy.numpy(), np.asarray(gy_j), **GRAD_TOL)


def test_backward_with_unused_outputs(rng):
    """Only X used (the likelihood's case): the unused log-det cotangents
    are skipped, and the gradient equals the full one with zero
    cotangents."""
    y = torch.as_tensor(_inputs(rng, 6, 10, 0.7))
    G = torch.as_tensor(rng.standard_normal((6, 5, 5)))
    (g1,) = _grads(lambda v: _vec_corr_inverse_all(v)[:1], y, (G,))
    zero = (G, torch.zeros(6), torch.zeros(6, 5))
    (g2,) = _grads(_vec_corr_inverse_all, y, zero)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-14, atol=1e-14)
    gx = torch.as_tensor(rng.standard_normal((6, 5)))
    ys = torch.as_tensor(_inputs(rng, 6, 4, 1.0))
    (h1,) = _grads(lambda v: SimplexBijector().inverse_and_log_det(v)[:1], ys, (gx,))
    (h2,) = _grads(SimplexBijector().inverse_and_log_det, ys, (gx, torch.zeros(6)))
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-14, atol=1e-14)
