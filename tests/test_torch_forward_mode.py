"""Forward mode through the port's link Functions against the JAX package.

Each link Function has a `jvp`: the simplex forward, x-only inverse and
inverse with its log-det and Dirichlet term (#9, #8, #7), the LKJ inverse
and log-det (#6, #5), the PD inverse, log-density and trace gradient (#10,
#11, #12). Same numpy inputs and tangents, float64 on the CPU, where the
wrappers run the plain versions: `torch.autograd.forward_ad` through the
entry points a user calls (`from_linked_vec`, `to_linked_vec`,
`linked_logdensity`, the composed transposed density) against `jax.jvp` at
1e-10, and each tangent against reverse mode's gradient dotted with the
tangent. The simplex inverse at K = 128 and 512 also runs the plain
version's associative scan (`kernels/simplex.py::simplex_inverse_scan`).
chip_smoke.py's path 25 checks the same on the card, with the primal from
the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from test_torch_fused import CPU64, spec_of

from tpu_bijectors import dists as jd
from tpu_bijectors.bijectors import pd as jpd
from tpu_bijectors.bijectors.simplex import SimplexBijector as JSimplex
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.bijectors import pd as tpd
from tpu_bijectors_torch.bijectors.simplex import SimplexBijector
from tpu_bijectors_torch.kernels import simplex as ks

TOL = dict(rtol=1e-10, atol=1e-10)

LEAVES = {
    "dirichlet": lambda: jd.Dirichlet(jnp.asarray([1.3, 2.0, 0.8, 1.1, 0.6])),
    "lkj": lambda: jd.LKJ(3, 2.0),
    "lkj4": lambda: jd.LKJ(4, 1.0),
    "lkjchol_L": lambda: jd.LKJCholesky(3, 1.5, "L"),
    "lkjchol_U": lambda: jd.LKJCholesky(3, 1.5, "U"),
    "wishart": lambda: jd.Wishart(6.0, jnp.asarray([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])),
    "invwishart": lambda: jd.InverseWishart(6.0, jnp.asarray([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])),
    "named": lambda: jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.3, 1.5), 3), w=jd.Dirichlet(jnp.ones(4)),
        c=jd.LKJ(3, 2.0), s=jd.Wishart(5.0, jnp.eye(3))),
}


def _np(t):
    return t.detach().numpy()


def _tangents(f, v, dv):
    """The tangents of f's outputs at v along dv, by forward mode."""
    with fwAD.dual_level():
        out = f(fwAD.make_dual(v, dv))
        out = out if isinstance(out, tuple) else (out,)
        return [{k: fwAD.unpack_dual(a).tangent for k, a in o.items()} if isinstance(o, dict)
                else fwAD.unpack_dual(o).tangent for o in out]


def _leaves(x):
    return [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_from_linked_vec_tangents_match_jax(rng, name):
    """The tangent of (x, logdet) of from_linked_vec, of linked_logdensity
    (the hooks: #7 with its data term, #5, #11) and of the composed
    transposed density, against jax.jvp; and the log-det's and density's
    tangents against reverse mode's gradient dotted with dv."""
    jdist = LEAVES[name]()
    uj = junconstrain(jdist)
    ut = tbt.unconstrain(tbt.dist_from_spec(spec_of(jdist), **CPU64), device="cpu")
    v = 0.7 * rng.standard_normal((5, uj.linked_vec_length))
    dv = rng.standard_normal(v.shape)
    tv, tdv = torch.as_tensor(v), torch.as_tensor(dv)

    (_, _), (dxj, dldj) = jax.jvp(uj.from_linked_vec, (jnp.asarray(v),), (jnp.asarray(dv),))
    dx, dld = _tangents(ut.from_linked_vec, tv, tdv)
    for got, ref in zip(_leaves(dx), _leaves(dxj)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_np(dld), np.asarray(dldj), **TOL)

    _, dlpj = jax.jvp(uj.linked_logdensity, (jnp.asarray(v),), (jnp.asarray(dv),))
    (dlp,) = _tangents(ut.linked_logdensity, tv, tdv)
    np.testing.assert_allclose(_np(dlp), np.asarray(dlpj), **TOL)
    (dlpT,) = _tangents(lambda a: ut._linked_logdensity_t_children(a.T), tv, tdv)
    np.testing.assert_allclose(_np(dlpT), np.asarray(dlpj), **TOL)

    for f, tangent in ((lambda a: ut.from_linked_vec(a)[1], dld), (ut.linked_logdensity, dlp)):
        vv = tv.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(f(vv).sum(), vv)
        np.testing.assert_allclose(_np(tangent), _np((g * tdv).sum(-1)), **TOL)


@pytest.mark.parametrize("name", ["dirichlet", "lkj", "lkjchol_U", "wishart", "named"])
def test_to_linked_vec_tangents_match_jax(rng, name):
    """The forward links (#9 for the simplex) in forward mode, at x from
    the inverse of seeded states, against jax.jvp."""
    jdist = LEAVES[name]()
    uj = junconstrain(jdist)
    ut = tbt.unconstrain(tbt.dist_from_spec(spec_of(jdist), **CPU64), device="cpu")
    v = 0.7 * rng.standard_normal((4, uj.linked_vec_length))
    dv = rng.standard_normal(v.shape)
    (xj, _), (dxj, _) = jax.jvp(uj.from_linked_vec, (jnp.asarray(v),), (jnp.asarray(dv),))
    _, (dyj, dldj) = jax.jvp(uj.to_linked_vec, (xj,), (dxj,))
    if isinstance(xj, dict):
        x = {k: torch.tensor(np.asarray(a)) for k, a in xj.items()}
        dx = {k: torch.tensor(np.asarray(a)) for k, a in dxj.items()}
        with fwAD.dual_level():
            y, ld = ut.to_linked_vec({k: fwAD.make_dual(x[k], dx[k]) for k in x})
            dy, dld = fwAD.unpack_dual(y).tangent, fwAD.unpack_dual(ld).tangent
    else:
        dy, dld = _tangents(ut.to_linked_vec, torch.tensor(np.asarray(xj)), torch.tensor(np.asarray(dxj)))
    np.testing.assert_allclose(_np(dy), np.asarray(dyj), **TOL)
    np.testing.assert_allclose(_np(dld), np.asarray(dldj), **TOL)


def test_simplex_x_only_inverse_tangent_matches_jax(rng):
    """SimplexBijector.inverse (#8's Function) against jax.jvp of the JAX
    bijector's inverse."""
    y = 0.8 * rng.standard_normal((6, 7))
    dy = rng.standard_normal(y.shape)
    _, dxj = jax.jvp(JSimplex().inverse, (jnp.asarray(y),), (jnp.asarray(dy),))
    (dx,) = _tangents(SimplexBijector().inverse, torch.as_tensor(y), torch.as_tensor(dy))
    np.testing.assert_allclose(_np(dx), np.asarray(dxj), **TOL)


@pytest.mark.parametrize("K", [128, 512])
def test_simplex_scan_inverse_at_large_k(rng, K):
    """At K >= 128 the plain inverse is the associative scan, as the JAX
    package's CPU path: x, the log-det and their tangents against it; the
    sequential recurrence agrees with the scan."""
    y = rng.standard_normal((3, K - 1))
    dy = rng.standard_normal(y.shape)
    (xj, ldj), (dxj, dldj) = jax.jvp(JSimplex().inverse_and_log_det, (jnp.asarray(y),),
                                     (jnp.asarray(dy),))
    ty = torch.as_tensor(y)
    x, ld = SimplexBijector().inverse_and_log_det(ty)
    np.testing.assert_allclose(_np(x), np.asarray(xj), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(_np(ld), np.asarray(ldj), rtol=1e-12)
    np.testing.assert_allclose(_np(ks.simplex_inverse_sequential(ty)), _np(x), rtol=1e-12, atol=1e-14)
    dx, dld = _tangents(SimplexBijector().inverse_and_log_det, ty, torch.as_tensor(dy))
    np.testing.assert_allclose(_np(dx), np.asarray(dxj), **TOL)
    np.testing.assert_allclose(_np(dld), np.asarray(dldj), rtol=1e-10)


@pytest.mark.parametrize("mode", ["dot", "solve"])
def test_pd_trace_grad_and_parameter_tangents(rng, mode):
    """#12's Function in forward mode (dy and dC) against jax.jvp of the
    JAX package's `_tr_grad_jnp`; #11's tangent in C against jax.jvp of
    `_pd_logdensity_jnp`; #11's C gradient against jax.grad."""
    K = 3
    y = 0.5 * rng.standard_normal((4, K * (K + 1) // 2))
    A = rng.standard_normal((K, K))
    C = A @ A.T + K * np.eye(K)
    C = np.linalg.cholesky(C) if mode == "solve" else 0.5 * (C + C.T)
    dy, dC = rng.standard_normal(y.shape), rng.standard_normal((K, K))
    if mode == "dot":
        dC = 0.5 * (dC + dC.T)
    _, dgj = jax.jvp(lambda a, c: jpd._tr_grad_jnp(a, c, mode), (jnp.asarray(y), jnp.asarray(C)),
                     (jnp.asarray(dy), jnp.asarray(dC)))
    ty, tC = torch.as_tensor(y), torch.as_tensor(C)
    with fwAD.dual_level():
        g = tpd._PDTraceGrad.apply(fwAD.make_dual(ty, torch.as_tensor(dy)), K,
                                   fwAD.make_dual(tC, torch.as_tensor(dC)), mode)
        dg = fwAD.unpack_dual(g).tangent
    np.testing.assert_allclose(_np(dg), np.asarray(dgj), **TOL)

    _, dtj = jax.jvp(lambda a, c: jpd._pd_logdensity_jnp(a, c, mode), (jnp.asarray(y), jnp.asarray(C)),
                     (jnp.asarray(dy), jnp.asarray(dC)))
    with fwAD.dual_level():
        outs = tpd._PDLogdensity.apply(fwAD.make_dual(ty, torch.as_tensor(dy)), K,
                                       fwAD.make_dual(tC, torch.as_tensor(dC)), mode)
        for o, r in zip(outs, dtj):
            np.testing.assert_allclose(_np(fwAD.unpack_dual(o).tangent), np.asarray(r), **TOL)

    w = rng.standard_normal(4)
    gCj = jax.grad(lambda c: jnp.sum(jnp.asarray(w) * jpd._pd_logdensity_jnp(jnp.asarray(y), c, mode)[2]))(
        jnp.asarray(C))
    tCg = tC.clone().requires_grad_(True)
    (gC,) = torch.autograd.grad((torch.as_tensor(w) * tpd._PDLogdensity.apply(ty, K, tCg, mode)[2]).sum(), tCg)
    np.testing.assert_allclose(_np(gC), np.asarray(gCj), **TOL)
