"""The port's flat-vector API against the JAX package.

Every case of `tests/test_vectorize.py::_cases` that the port builds, on
the same numpy inputs in float64 on the CPU: `vec_length`,
`linked_vec_length`, `to_vec` / `from_vec`, the linked round trips,
`UnconstrainerBijector`, the optics (`optic_vec`, `linked_optic_vec`,
`Optic.get`) and the Jacobian sparsity of the optics that are not
entangled; the eight module-level functions; `Product`; and the gradient
of the transposed density with respect to distribution parameters (which
takes the composed path) against `jax.grad` over the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from test_torch_fused import CPU64, spec_of

import tpu_bijectors as tb
from tpu_bijectors import dists as jd
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import vectorize as tv
from tpu_bijectors_torch.testing.sweep import jacfwd
from tpu_bijectors_torch.vectorize import fused_kernel as tfk

TOL = dict(rtol=1e-10, atol=1e-10)

CASES = {
    "normal": lambda: jd.Normal(0.5, 2.0),
    "lognormal": lambda: jd.LogNormal(),
    "beta": lambda: jd.Beta(2.0, 3.0),
    "uniform": lambda: jd.Uniform(-2.0, 5.0),
    "dirichlet": lambda: jd.Dirichlet(jnp.asarray([2.0, 3.0, 4.0])),
    "mvnormal": lambda: jd.MvNormalDiag(jnp.zeros(4), jnp.ones(4)),
    "mvlognormal": lambda: jd.MvLogNormal(jnp.zeros(3), jnp.ones(3)),
    "lkj": lambda: jd.LKJ(4, 2.0),
    "lkjchol_L": lambda: jd.LKJCholesky(3, 1.5, "L"),
    "lkjchol_U": lambda: jd.LKJCholesky(3, 1.5, "U"),
    "wishart": lambda: jd.Wishart(6.0, jnp.eye(3, dtype=jnp.float64)),
    "iid_beta": lambda: jd.IIDProduct(jd.Beta(2.0, 2.0), 10),
    "iid_dirichlet": lambda: jd.IIDProduct(jd.Dirichlet(jnp.ones(3)), 4),
    "tuple_product": lambda: jd.Product((jd.LogNormal(), jd.Dirichlet(jnp.ones(3)),
                                         jd.MvNormalDiag(jnp.zeros(2), jnp.ones(2)))),
    "named_product": lambda: jd.NamedProduct.of(mu=jd.Normal(), sigma=jd.LogNormal(),
                                                w=jd.Dirichlet(jnp.ones(4)), corr=jd.LKJ(3, 2.0)),
    "nested_named": lambda: jd.NamedProduct.of(a=jd.IIDProduct(jd.Gamma(2.0, 3.0), 5),
                                               b=jd.Product((jd.Beta(1.0, 2.0), jd.Normal()))),
    "transformed": lambda: tb.transformed(jd.LogNormal()),
}


def port_spec(d):
    """`spec_of` with the tuple product (its children a list)."""
    kind = type(d).__name__
    if kind == "Product":
        return {"type": kind, "children": [port_spec(c) for c in d.components]}
    if kind == "NamedProduct":
        return {"type": kind, "children": {n: port_spec(c) for n, c in zip(d.names, d.components)}}
    return spec_of(d)


def _pair(name):
    d = CASES[name]()
    return d, junconstrain(d), tbt.unconstrain(tbt.dist_from_spec(port_spec(d), **CPU64), device="cpu")


def _np(t):
    return t.detach().numpy()


def _to_port(x):
    if isinstance(x, dict):
        return {k: _to_port(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_port(v) for v in x)
    return torch.tensor(np.asarray(x))


def _flat(x):
    if isinstance(x, dict):
        return [t for k in x for t in _flat(x[k])]
    if isinstance(x, tuple):
        return [t for v in x for t in _flat(v)]
    return [x]


def _close(got, ref, tol):
    g, r = _flat(got), _flat(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


def _optic_key(o):
    return None if o is None else (tuple(o.path), tuple(int(i) for i in o.index))


@pytest.mark.parametrize("name", sorted(CASES))
def test_vec_api_matches_jax(rng, name):
    """Lengths; from_linked_vec of seeded states; to_vec of those samples,
    from_vec(to_vec(x)) bit for bit; to_linked_vec; and
    UnconstrainerBijector against to_linked_vec / from_linked_vec bit for
    bit."""
    _, uj, ut = _pair(name)
    assert (ut.vec_length, ut.linked_vec_length) == (uj.vec_length, uj.linked_vec_length)
    y = rng.standard_normal((4, ut.linked_vec_length))
    xs, lds = ut.from_linked_vec(torch.as_tensor(y))
    xsj, ldsj = uj.from_linked_vec(jnp.asarray(y))
    _close(xs, xsj, TOL)
    np.testing.assert_allclose(_np(lds), np.asarray(ldsj), **TOL)
    x = _to_port(xsj)
    v = ut.to_vec(x)
    np.testing.assert_allclose(_np(v), np.asarray(uj.to_vec(xsj)), rtol=0, atol=0)
    for a, b in zip(_flat(ut.from_vec(v)), _flat(x)):
        assert torch.equal(a, b)
    lv, ld = ut.to_linked_vec(x)
    lvj, ldj = uj.to_linked_vec(xsj)
    np.testing.assert_allclose(_np(lv), np.asarray(lvj), **TOL)
    np.testing.assert_allclose(_np(ld), np.asarray(ldj), **TOL)
    b = tv.UnconstrainerBijector(ut)
    yb, ldb = b.forward_and_log_det(x)
    assert torch.equal(yb, lv) and torch.equal(ldb, ld)
    xb, ldib = b.inverse_and_log_det(torch.as_tensor(y))
    assert all(torch.equal(p, q) for p, q in zip(_flat(xb), _flat(xs))) and torch.equal(ldib, lds)
    assert b.forward_event_shape(()) == (ut.linked_vec_length,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_optics_match_jax_and_jacobian_sparsity(rng, name):
    """optic_vec and linked_optic_vec equal the JAX package's, each plain
    optic reads its to_vec slot of a sample, and a linked slot with an
    optic depends on that element alone (the forward-mode Jacobian of
    to_linked_vec(from_vec(v)), as the JAX sweep's jacfwd)."""
    _, uj, ut = _pair(name)
    ov, lov = ut.optic_vec(), ut.linked_optic_vec()
    assert [_optic_key(o) for o in ov] == [_optic_key(o) for o in uj.optic_vec()]
    assert [_optic_key(o) for o in lov] == [_optic_key(o) for o in uj.linked_optic_vec()]
    xs, _ = ut.from_linked_vec(torch.as_tensor(0.3 * rng.standard_normal(ut.linked_vec_length)))
    xv = ut.to_vec(xs)
    for j, o in enumerate(ov):
        assert float(o.get(xs)) == float(xv[j])
    J = _np(jacfwd(lambda vv: ut.to_linked_vec(ut.from_vec(vv))[0], xv))
    for i, o in enumerate(lov):
        if o is not None:
            j = ov.index(o)
            np.testing.assert_allclose(np.delete(J[i], j), 0.0, atol=1e-12)


def test_module_level_functions_and_optic():
    """The eight module-level functions on a named product, and Optic's
    equality, prefix and repr."""
    d = jd.NamedProduct.of(mu=jd.Normal(), w=jd.Dirichlet(jnp.ones(3)), c=jd.LKJCholesky(3, 1.0, "L"))
    pd = tbt.dist_from_spec(port_spec(d), **CPU64)
    uj = junconstrain(d)
    assert tv.vec_length(pd, device="cpu") == uj.vec_length == 1 + 3 + 6
    assert tv.linked_vec_length(pd, device="cpu") == uj.linked_vec_length == 1 + 2 + 3
    assert [_optic_key(o) for o in tv.optic_vec(pd, device="cpu")] == [
        _optic_key(o) for o in uj.optic_vec()]
    assert [_optic_key(o) for o in tv.linked_optic_vec(pd, device="cpu")] == [
        _optic_key(o) for o in uj.linked_optic_vec()]
    y = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64)
    x, ld = tv.from_linked_vec(pd, device="cpu")(y)
    y2, ld2 = tv.to_linked_vec(pd, device="cpu")(x)
    np.testing.assert_allclose(_np(y2), _np(y), **TOL)
    np.testing.assert_allclose(_np(ld2), -_np(ld), **TOL)
    v = tv.to_vec(pd, device="cpu")(x)
    assert all(torch.equal(a, b) for a, b in zip(_flat(tv.from_vec(pd, device="cpu")(v)), _flat(x)))
    o = tv.Optic(("w",), (2,))
    assert o == tv.Optic(("w",), (2,)) and o != tv.Optic(("w",), (1,))
    assert o.prefix(0) == tv.Optic((0, "w"), (2,))
    assert repr(o.prefix(0)) == "Optic(_[0].w[2])"


def _param_model(ns, alpha, eta, df, scale, loc, **kw):
    return ns.NamedProduct.of(w=ns.Dirichlet(alpha, **kw), c=ns.LKJ(3, eta, **kw),
                              s=ns.Wishart(df, scale, **kw), m=ns.Normal(loc, 1.5, **kw))


def test_parameter_gradients_of_transposed_density(rng):
    """d sum(linked_logdensity_t) / d (alpha, eta, df, scale, loc) against
    jax.grad over the parameters: the port takes the composed path (the
    dispatch hook declines), with the PD log-density's C gradient; without
    a gradient on the parameters the fused path serves the call; a
    forward-mode tangent of alpha matches jax.jvp."""
    p = dict(alpha=np.asarray([1.3, 2.0, 0.8, 1.1]), eta=np.asarray(2.0), df=np.asarray(6.0),
             scale=np.asarray([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]]),
             loc=np.asarray(0.3))
    dim = 3 + 3 + 6 + 1
    vT = 0.6 * rng.standard_normal((dim, 7))

    def jax_lp(q):
        return jnp.sum(junconstrain(_param_model(jd, **q)).linked_logdensity_t(jnp.asarray(vT)))

    gj = jax.grad(jax_lp)({k: jnp.asarray(a) for k, a in p.items()})
    tp = {k: torch.tensor(a, requires_grad=True) for k, a in p.items()}
    u = tbt.unconstrain(_param_model(tbt.dists, **tp, device="cpu"), device="cpu")
    vTt = torch.as_tensor(vT)
    assert not tfk._fused_applies(u, vTt)
    lp = u.linked_logdensity_t(vTt)
    g = torch.autograd.grad(lp.sum(), [tp[k] for k in p])
    for k, gk in zip(p, g):
        np.testing.assert_allclose(_np(gk), np.asarray(gj[k]), **TOL, err_msg=k)
    # the same model without parameter gradients: the fused evaluation
    u0 = tbt.unconstrain(_param_model(tbt.dists, **{k: torch.tensor(a) for k, a in p.items()},
                                      device="cpu"), device="cpu")
    assert tfk._fused_applies(u0, vTt)
    # the fused Dirichlet is the reference's un-nudged telescoped form, the
    # composed one takes logpdf(x + eps): about 1e-9 apart
    np.testing.assert_allclose(_np(u0.linked_logdensity_t(vTt)), _np(lp), rtol=1e-8)
    with pytest.raises(NotImplementedError, match="composed path"):
        tfk._prep(u, vTt)
    # forward mode: a tangent on alpha
    dalpha = rng.standard_normal(4)
    _, dj = jax.jvp(lambda a: jax_lp({**{k: jnp.asarray(b) for k, b in p.items()}, "alpha": a}),
                    (jnp.asarray(p["alpha"]),), (jnp.asarray(dalpha),))
    with fwAD.dual_level():
        a = fwAD.make_dual(torch.tensor(p["alpha"]), torch.as_tensor(dalpha))
        uf = tbt.unconstrain(_param_model(tbt.dists, a, *(torch.tensor(p[k]) for k in
                                                          ("eta", "df", "scale", "loc")),
                                          device="cpu"), device="cpu")
        dlp = fwAD.unpack_dual(uf.linked_logdensity_t(vTt).sum()).tangent
    np.testing.assert_allclose(float(dlp), float(dj), **TOL)


def test_matrixnormal_and_reshaped_wait_for_their_families():
    pytest.skip("MatrixNormal and Reshaped (tests/test_vectorize.py's optics cases) are not "
                "ported yet: ROADMAP.md Queue 1 item 5")
