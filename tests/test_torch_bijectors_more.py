"""The port's remaining bijectors against the JAX package: the scalar maps,
Chain, Block and `inverse`, Stacked, Reshape, Permute, ProductBijector,
NamedTransform, NamedCoupling, PartitionMask, Coupling, the linear maps,
CorrBijector and `bijector_from_spec` (the cases of tests/test_structural.py,
test_scalar_bijectors.py, test_chain_mixed.py and test_matrix_bijectors.py).

Both packages' bijectors are built from one spec (`bijector_from_spec` and
the JAX twin `_jax_bijector` below) and run on the same numpy inputs from a
seed, in float64 on the CPU: values and log-dets to 1e-10, log-dets also
against log|det| of `torch.func.jacrev`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_bijectors as tb

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import bijector_from_spec
from tpu_bijectors_torch.utils import triu_to_vec, vec_to_triu

TOL = dict(rtol=1e-10, atol=1e-10)
F64 = dict(device="cpu", dtype=torch.float64)


def _jax_bijector(spec):
    """The JAX package's bijector for a `bijector_from_spec` spec."""
    kind = spec["type"]
    if kind in ("Chain", "ProductBijector"):
        return getattr(tb, kind)(tuple(_jax_bijector(c) for c in spec["children"]))
    if kind == "Stacked":
        return tb.Stacked(tuple(_jax_bijector(c) for c in spec["children"]),
                          tuple(tuple(r) for r in spec["ranges_in"]))
    if kind == "NamedTransform":
        return tb.NamedTransform.of(**{k: _jax_bijector(c) for k, c in spec["children"].items()})
    if kind in ("Block", "Invert"):
        static = {k: v for k, v in spec.items() if k not in ("type", "inner")}
        return getattr(tb, kind)(_jax_bijector(spec["inner"]), **static)
    params = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in spec.get("params", {}).items()}
    static = {k: v for k, v in spec.items() if k not in ("type", "params")}
    return getattr(tb, kind)(**static, **params)


def _both(spec):
    return _jax_bijector(spec), bijector_from_spec(spec, **F64)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _jac_logdet(f, x, jacobian=torch.func.jacrev):
    """log|det| of f's Jacobian at the flat point x."""
    J = jacobian(f)(x) if jacobian is torch.func.jacrev else jacobian(f, x)
    return torch.linalg.slogdet(J)[1]


def _rng():
    return np.random.default_rng(17)


# ---------------------------------------------------------------------------
# scalar maps
# ---------------------------------------------------------------------------

_A2 = np.asarray([0.7, -1.3])
SCALAR_CASES = {
    "Exp": ({"type": "Exp"}, "real"),
    "Log": ({"type": "Log"}, "positive"),
    "Logit(-1, 3)": ({"type": "Logit", "params": {"a": -1.0, "b": 3.0}}, "interval"),
    "Shift(array)": ({"type": "Shift", "params": {"a": _A2}}, "real"),
    "Scale(-2.5)": ({"type": "Scale", "params": {"a": -2.5}}, "real"),
    "Scale(array)": ({"type": "Scale", "params": {"a": _A2}}, "real"),
    "LeakyReLU(0.2)": ({"type": "LeakyReLU", "params": {"alpha": 0.2}}, "real"),
    "Softplus": ({"type": "Softplus"}, "real"),
    "SignFlip": ({"type": "SignFlip"}, "real"),
}


def _scalar_input(domain, shape):
    z = _rng().standard_normal(shape)
    return {"real": 2.0 * z, "positive": np.exp(z), "interval": -1.0 + 4.0 / (1.0 + np.exp(-z))}[domain]


@pytest.mark.parametrize("name", list(SCALAR_CASES))
def test_scalar_maps_against_jax(name):
    spec, domain = SCALAR_CASES[name]
    jb, tbj = _both(spec)
    x = _scalar_input(domain, (5, 2))
    y, ld = tbj.forward_and_log_det(torch.as_tensor(x))
    yj, ldj = jax.jit(jb.forward_and_log_det)(jnp.asarray(x))
    _close(y, yj)
    _close(ld, ldj)
    _close(tbj.forward(torch.as_tensor(x)), yj)
    xr, ldi = tbj.inverse_and_log_det(y)
    xj, ldij = jax.jit(jb.inverse_and_log_det)(yj)
    _close(xr, xj)
    _close(ldi, ldij)
    _close(xr, x)
    _close(tbj.inverse(y), x)
    # elementwise: log|dy/dx| on the diagonal of the Jacobian of the flat map
    xf = torch.as_tensor(x[0])
    J = torch.func.jacrev(tbj.forward)(xf)
    _close(torch.log(torch.abs(torch.diagonal(J))), tbj.forward_and_log_det(xf)[1])
    assert torch.count_nonzero(J - torch.diag(torch.diagonal(J))) == 0
    assert (tbj.monotonically_increasing, tbj.monotonically_decreasing) == (
        jb.monotonically_increasing, jb.monotonically_decreasing)


def test_self_inverses_and_traits():
    assert tbt.inverse(tbt.Exp()) == tbt.Log() and tbt.inverse(tbt.Log()) == tbt.Exp()
    assert tbt.inverse(tbt.SignFlip()) == tbt.SignFlip()
    assert tbt.inverse(tbt.Identity()) == tbt.Identity()
    assert tbt.inverse(tbt.Reshape((6,), (2, 3))) == tbt.Reshape((2, 3), (6,))
    assert tbt.inverse(tbt.Permute((2, 0, 1))) == tbt.Permute((1, 2, 0))
    assert tbt.inverse(tbt.inverse(tbt.Shift(1.0))) == tbt.Shift(1.0)
    assert isinstance(tbt.inverse(tbt.Shift(1.0)), tbt.Invert)
    # Scale's direction from the sign of a static scale; none for a tensor
    assert tbt.Scale(2.0).monotonically_increasing and tbt.Scale(-2.0).monotonically_decreasing
    s = tbt.Scale(torch.tensor(2.0))
    assert not (s.monotonically_increasing or s.monotonically_decreasing)
    # the sign table through Chain, Invert and Block, as the JAX package's
    flip, e = tbt.SignFlip(), tbt.Exp()
    cases = [(tbt.Chain((flip, e)), tb.Chain((tb.SignFlip(), tb.Exp()))),
             (tbt.Chain((flip, flip, e)), tb.Chain((tb.SignFlip(), tb.SignFlip(), tb.Exp()))),
             (tbt.Chain((e, tbt.Scale(torch.tensor(2.0)))), tb.Chain((tb.Exp(), tb.Scale(jnp.asarray(2.0))))),
             (tbt.Invert(tbt.Chain((flip, e))), tb.Invert(tb.Chain((tb.SignFlip(), tb.Exp())))),
             (tbt.Block(flip, 1), tb.Block(tb.SignFlip(), 1)),
             (tbt.Block(tbt.Chain((e, e)), 1), tb.Block(tb.Chain((tb.Exp(), tb.Exp())), 1))]
    for ours, theirs in cases:
        for trait in ("monotonically_increasing", "monotonically_decreasing",
                      "closed_form_inverse", "invertible"):
            assert getattr(ours, trait) == getattr(theirs, trait), (ours, trait)
    # >> and <<: b >> c is c after b
    x = torch.tensor([0.3, -0.2], dtype=torch.float64)
    _close((tbt.Exp() >> tbt.Shift(1.0)).forward(x), np.exp(x.numpy()) + 1.0)
    _close((tbt.Exp() << tbt.Shift(1.0)).forward(x), np.exp(x.numpy() + 1.0))
    assert tbt.Exp()(x).equal(torch.exp(x))


# ---------------------------------------------------------------------------
# Chain with mixed ranks (tests/test_chain_mixed.py)
# ---------------------------------------------------------------------------

def test_chain_event_ndims_and_elementwise():
    assert (tbt.Chain((tbt.Exp(), tbt.Shift(1.0))).event_ndims_in,) == (0,)
    c = tbt.Chain((tbt.OrderedBijector(), tbt.Exp()))
    assert (c.event_ndims_in, c.event_ndims_out) == (1, 1)
    c = tbt.Chain((tbt.Exp(), tbt.inverse(tbt.SimplexBijector())))
    assert (c.event_ndims_in, c.event_ndims_out) == (1, 1)
    c = tbt.Chain((tbt.Exp(), tbt.Scale(2.0), tbt.Shift(1.0)))
    x = torch.arange(6.0, dtype=torch.float64).reshape(2, 3)
    y, ld = c.forward_and_log_det(x)
    assert ld.shape == x.shape
    _close(y, np.exp(2.0 * x.numpy() + 2.0))
    with pytest.raises(ValueError, match="event dims"):
        tbt.Chain((tbt.OrderedBijector(), tbt.Exp())).forward_and_log_det(torch.tensor(1.0))


@pytest.mark.parametrize("order", ["scalar-then-vector", "vector-then-scalar", "dim-change"])
def test_mixed_chains_against_jax(order):
    x = _rng().standard_normal((5, 4))
    if order == "scalar-then-vector":
        spec_members = (tbt.OrderedBijector(), tbt.Exp()), (tb.OrderedBijector(), tb.Exp())
    elif order == "vector-then-scalar":
        spec_members = (tbt.Exp(), tbt.OrderedBijector()), (tb.Exp(), tb.OrderedBijector())
    else:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        spec_members = ((tbt.inverse(tbt.SimplexBijector()), tbt.Scale(1.5)),
                        (tb.inverse(tb.SimplexBijector()), tb.Scale(1.5)))
    c, cj = tbt.Chain(spec_members[0]), tb.Chain(spec_members[1])
    y, ld = c.forward_and_log_det(torch.as_tensor(x))
    yj, ldj = jax.jit(cj.forward_and_log_det)(jnp.asarray(x))
    assert ld.shape == (5,)
    _close(y, yj)
    _close(ld, ldj)
    xr, ldi = c.inverse_and_log_det(y)
    _close(xr, x, dict(rtol=1e-9, atol=1e-9))
    _close(ldi, -ld.detach().numpy())
    if order != "dim-change":
        _close(_jac_logdet(c.forward, torch.as_tensor(x[0])), ld[0])


# ---------------------------------------------------------------------------
# Stacked, Reshape, Permute (tests/test_structural.py)
# ---------------------------------------------------------------------------

STACKED_SPEC = {"type": "Stacked", "ranges_in": ((0, 1), (1, 2), (3, 3)), "children": [
    {"type": "Exp"},
    {"type": "Block", "ndims": 1, "inner": {"type": "Logit", "params": {"a": 0.0, "b": 1.0}}},
    {"type": "Identity"}]}


def test_stacked_against_jax():
    jb, b = _both(STACKED_SPEC)
    x = np.asarray([0.5, 0.3, 0.7, -1.0, 2.0, 0.1])
    xb = np.stack([x, x * 0.5 + 0.1, x * 0.9])
    for inp in (x, xb):
        y, ld = b.forward_and_log_det(torch.as_tensor(inp))
        yj, ldj = jax.jit(jb.forward_and_log_det)(jnp.asarray(inp))
        _close(y, yj)
        _close(ld, ldj)
        xr, ldi = b.inverse_and_log_det(y)
        _close(xr, inp)
        _close(ldi, -np.asarray(ldj))
        _close(b.forward(torch.as_tensor(inp)), yj)
        _close(b.inverse(y), inp)
    _close(_jac_logdet(b.forward, torch.as_tensor(x)), b.forward_and_log_det(torch.as_tensor(x))[1])


def test_stacked_dim_changing_and_batched():
    b = tbt.Stacked.from_lengths((tbt.SimplexBijector(), tbt.Block(tbt.Log(), 1)), (4, 2))
    jb = tb.Stacked.from_lengths((tb.SimplexBijector(), tb.Block(tb.Log(), 1)), (4, 2))
    assert (b.length_in, b.length_out) == (6, 5) == (jb.length_in, jb.length_out)
    assert b.ranges_out == jb.ranges_out
    # the output ranges and lengths are derived, never a constructor's
    with pytest.raises(TypeError):
        tbt.Stacked(b.bijectors, b.ranges_in, ranges_out=((0, 9),))
    w = np.random.default_rng(3).dirichlet(np.ones(4), size=3)
    x = np.concatenate([w, np.asarray([[1.5, 2.5]] * 3)], axis=-1)
    y, ld = b.forward_and_log_det(torch.as_tensor(x))
    yj, ldj = jb.forward_and_log_det(jnp.asarray(x))
    assert y.shape == (3, 5)
    _close(y, yj)
    _close(ld, ldj)
    xr, ldi = b.inverse_and_log_det(y)
    _close(xr, x, dict(rtol=1e-9, atol=1e-9))
    _close(ldi, -np.asarray(ldj))
    bb = tbt.Stacked.from_lengths((tbt.Block(tbt.Exp(), 1), tbt.Block(tbt.Identity(), 1)), (2, 2))
    y, ld = bb.forward_and_log_det(torch.as_tensor(_rng().standard_normal((7, 4))))
    assert y.shape == (7, 4) and ld.shape == (7,)
    with pytest.raises(ValueError):
        bb.forward(torch.zeros(3))


def test_reshape():
    b = tbt.Reshape((6,), (2, 3))
    x = torch.arange(6.0, dtype=torch.float64)
    y, ld = b.forward_and_log_det(x)
    assert y.shape == (2, 3) and float(ld) == 0.0
    assert torch.equal(b.inverse(y), x)
    yb, ldb = b.forward_and_log_det(torch.ones(5, 6, dtype=torch.float64))
    assert yb.shape == (5, 2, 3) and ldb.shape == (5,)
    assert (b.event_ndims_in, b.event_ndims_out) == (1, 2)
    assert b.forward_event_shape((4, 6)) == (4, 2, 3)
    with pytest.raises(ValueError):
        tbt.Reshape((6,), (4,))


def test_permute_forms():
    P = tbt.Permute
    x = torch.tensor([10.0, 20.0, 30.0], dtype=torch.float64)
    b = P((2, 0, 1))
    y, ld = b.forward_and_log_det(x)
    assert y.tolist() == [30.0, 10.0, 20.0] and float(ld) == 0.0
    assert torch.equal(b.inverse(y), x) and torch.equal(tbt.inverse(b).forward(y), x)
    _close(y, tb.Permute((2, 0, 1)).forward(jnp.asarray(x.numpy())))
    assert P.from_matrix([[0, 1], [1, 0]]) == P((1, 0)) == P.from_pairs(2, {1: 0, 0: 1})
    assert P.from_matrix([[0, 1, 0], [1, 0, 0], [0, 0, 1]]).perm == P.from_pairs(3, {1: 0, 0: 1}).perm
    assert P.from_destinations([1, 2, 0]).forward(x).tolist() == [30.0, 10.0, 20.0]
    A = np.zeros((3, 3))
    A[1, 0] = A[2, 1] = A[0, 2] = 1.0
    assert P.from_matrix(A) == P.from_destinations([1, 2, 0])
    assert P.from_vector_pairs(4, ([0, 1], [1, 0])) == P.from_pairs(4, {0: 1, 1: 0})
    for bad in (lambda: P.from_pairs(2, {1: 0, 0: 0}), lambda: P.from_matrix([[1, 1], [0, 0]]),
                lambda: P.from_matrix([[0, -1], [-1, 0]]),
                lambda: P.from_vector_pairs(4, ([0, 1], [1])),
                lambda: P.from_vector_pairs(4, ([0], [1]), ([0], [2])), lambda: P((0, 0))):
        with pytest.raises(ValueError):
            bad()
    for jf, tf in ((tb.Permute.from_destinations([1, 2, 0]), P.from_destinations([1, 2, 0])),
                   (tb.Permute.from_vector_pairs(3, ([0, 2], [2, 0])),
                    P.from_vector_pairs(3, ([0, 2], [2, 0])))):
        assert jf.perm == tf.perm


# ---------------------------------------------------------------------------
# ProductBijector, NamedTransform, NamedCoupling
# ---------------------------------------------------------------------------

def test_product_bijector_against_jax():
    spec = {"type": "ProductBijector", "children": [
        {"type": "Exp"}, {"type": "Identity"}, {"type": "Logit", "params": {"a": 0.0, "b": 1.0}}]}
    jb, b = _both(spec)
    x = np.asarray([0.5, -1.0, 0.25])
    xb = np.asarray([[0.5, -1.0, 0.25], [0.1, 2.0, 0.75]])
    for inp in (x, xb):
        y, ld = b.forward_and_log_det(torch.as_tensor(inp))
        yj, ldj = jb.forward_and_log_det(jnp.asarray(inp))
        _close(y, yj)
        _close(ld, ldj)
        xr, ldi = b.inverse_and_log_det(y)
        _close(xr, inp)
        _close(ldi, -np.asarray(ldj))
    _close(_jac_logdet(b.forward, torch.as_tensor(x)), b.forward_and_log_det(torch.as_tensor(x))[1])


def test_named_transform_and_coupling():
    spec = {"type": "NamedTransform", "children": {
        "a": {"type": "Exp"},
        "c": {"type": "Block", "ndims": 1, "inner": {"type": "Logit", "params": {"a": 0.0, "b": 1.0}}}}}
    jb, b = _both(spec)
    x = {"a": np.asarray(0.3), "b": np.asarray([1.0, 2.0]), "c": np.asarray([0.2, 0.8])}
    y, ld = b.forward_and_log_det({k: torch.as_tensor(v) for k, v in x.items()})
    yj, ldj = jb.forward_and_log_det({k: jnp.asarray(v) for k, v in x.items()})
    for k in x:
        _close(y[k], yj[k])
    _close(ld, ldj)
    assert torch.equal(y["b"], torch.as_tensor(x["b"]))
    xr, ldi = b.inverse_and_log_det(y)
    for k in x:
        _close(xr[k], x[k])
    _close(ldi, -np.asarray(ldj))
    nc = tbt.NamedCoupling("x", ("s",), lambda s: tbt.Scale(s))
    jnc = tb.NamedCoupling("x", ("s",), lambda s: tb.Scale(s))
    v = {"x": np.asarray([1.0, 2.0]), "s": np.asarray(3.0)}
    y, ld = nc.forward_and_log_det({k: torch.as_tensor(a) for k, a in v.items()})
    yj, ldj = jnc.forward_and_log_det({k: jnp.asarray(a) for k, a in v.items()})
    _close(y["x"], [3.0, 6.0])
    _close(ld, ldj)
    _close(ld, 2 * np.log(3.0))
    xr, _ = nc.inverse_and_log_det(y)
    _close(xr["x"], v["x"])


# ---------------------------------------------------------------------------
# PartitionMask and Coupling
# ---------------------------------------------------------------------------

def test_partition_mask():
    for args in ((3, (0,), (1,)), (5, (0, 3)), (5, (4,), None, (0, 1)), (4, (2,), (0,), (1, 3))):
        m, mj = tbt.PartitionMask(*args), tb.PartitionMask(*args)
        assert (m.idx1, m.idx2, m.idx3) == (mj.idx1, mj.idx2, mj.idx3)
        x = np.arange(1.0, args[0] + 1.0)
        parts = m.partition(torch.as_tensor(x))
        for p, pj in zip(parts, mj.partition(jnp.asarray(x))):
            _close(p, pj)
        assert torch.equal(m.combine(*parts), torch.as_tensor(x))


class _Conditioner(torch.nn.Module):
    """A Shift-after-Scale conditioner with trainable weights."""

    def __init__(self, w, c):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w))
        self.c = torch.nn.Parameter(torch.as_tensor(c))


def _theta_module(p, x2):
    return tbt.Block(tbt.Chain((tbt.Shift(x2 @ p.c), tbt.Scale(torch.exp(x2 @ p.w)))), 1)


def _theta_tuple(p, x2):
    w, c = p
    return tbt.Block(tbt.Chain((tbt.Shift(x2 @ c), tbt.Scale(torch.exp(x2 @ w)))), 1)


def _theta_jax(p, x2):
    w, c = p
    return tb.Block(tb.Chain((tb.Shift(x2 @ c), tb.Scale(jnp.exp(x2 @ w)))), 1)


def test_coupling_against_jax():
    mask = tbt.PartitionMask(3, (0,), (1,))
    b = tbt.Coupling(lambda x2: tbt.Block(tbt.Shift(x2), 1), mask)
    y, ld = b.forward_and_log_det(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    assert y.tolist() == [3.0, 2.0, 3.0] and float(ld) == 0.0
    rng = np.random.default_rng(5)
    w, c = 0.3 * rng.standard_normal((2, 2)), rng.standard_normal((2, 2))
    x = rng.standard_normal((5, 4))
    jb = tb.Coupling(_theta_jax, tb.PartitionMask(4, (0, 1), (2, 3)), (jnp.asarray(w), jnp.asarray(c)))
    yj, ldj = jax.jit(jb.forward_and_log_det)(jnp.asarray(x))
    m4 = tbt.PartitionMask(4, (0, 1), (2, 3))
    for b in (tbt.Coupling(_theta_module, m4, _Conditioner(w, c)),
              tbt.Coupling(_theta_tuple, m4, (torch.as_tensor(w), torch.as_tensor(c)))):
        y, ld = b.forward_and_log_det(torch.as_tensor(x))
        assert ld.shape == (5,)
        _close(y, yj)
        _close(ld, ldj)
        xr, ldi = b.inverse_and_log_det(y)
        _close(xr, x)
        _close(ldi, -np.asarray(ldj))
        _close(_jac_logdet(b.forward, torch.as_tensor(x[0])), ld[0])
    # the module's weights reach torch.optim's gradients, as jax.grad's
    cond = _Conditioner(w, c)
    y, ld = tbt.Coupling(_theta_module, m4, cond).forward_and_log_det(torch.as_tensor(x))
    (ld.sum() + (y ** 2).sum()).backward()

    def loss(p):
        y, ld = tb.Coupling(_theta_jax, tb.PartitionMask(4, (0, 1), (2, 3)), p).forward_and_log_det(
            jnp.asarray(x))
        return jnp.sum(ld) + jnp.sum(y ** 2)

    gw = jax.jit(jax.grad(loss))((jnp.asarray(w), jnp.asarray(c)))
    _close(cond.w.grad, gw[0])
    _close(cond.c.grad, gw[1])


# ---------------------------------------------------------------------------
# LinearMap and TriangularLinearMap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_type,lower", [("LinearMap", None), ("TriangularLinearMap", True),
                                             ("TriangularLinearMap", False)])
def test_linear_maps_against_jax(spec_type, lower):
    rng = np.random.default_rng(11)
    A = rng.standard_normal((4, 4)) + 3.0 * np.eye(4)
    spec = {"type": spec_type, "params": {"A" if lower is None else "T": A}}
    if lower is not None:
        spec["lower"] = lower
    jb, b = _both(spec)
    x = rng.standard_normal((3, 2, 4))
    y, ld = b.forward_and_log_det(torch.as_tensor(x))
    yj, ldj = jax.jit(jb.forward_and_log_det)(jnp.asarray(x))
    assert ld.shape == (3, 2)
    _close(y, yj)
    _close(ld, ldj)
    xr, ldi = b.inverse_and_log_det(y)
    xj, ldij = jax.jit(jb.inverse_and_log_det)(yj)
    _close(xr, xj)
    _close(xr, x)
    _close(ldi, ldij)
    _close(b.inverse(y), x)
    _close(_jac_logdet(b.forward, torch.as_tensor(x[0, 0])), ld[0, 0])


# ---------------------------------------------------------------------------
# CorrBijector, the matrix form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 3, 6])
def test_corr_bijector_against_jax(K):
    rng = np.random.default_rng(K)
    y = rng.standard_normal((4, K * (K - 1) // 2))
    Y = np.array(tb.utils.vec_to_triu(jnp.asarray(y), k=1, n=K))
    b, jb = tbt.CorrBijector(), tb.CorrBijector()
    assert (b.event_ndims_in, b.event_ndims_out) == (2, 2)
    X, logJ = b.inverse_and_log_det(torch.as_tensor(Y))
    Xj, logJj = jax.jit(jb.inverse_and_log_det)(jnp.asarray(Y))
    _close(X, Xj)
    _close(logJ, logJj)
    Yf, ld = b.forward_and_log_det(X)
    Yj, ldj = jax.jit(jb.forward_and_log_det)(Xj)
    _close(Yf, Yj)
    _close(Yf, Y)
    _close(ld, ldj)
    _close(b.inverse_log_det_jacobian(torch.as_tensor(Y)),
           jax.jit(jb.inverse_log_det_jacobian)(jnp.asarray(Y)))
    # the log-det of the free coordinates' map, the strict upper triangles

    def f(v):
        return triu_to_vec(b.inverse(vec_to_triu(v, 1, K)), 1)

    # (the link Function is a classic autograd.Function: torch.func
    # transforms do not enter it, torch.autograd.functional does)
    _close(_jac_logdet(f, torch.as_tensor(y[0]), torch.autograd.functional.jacobian), logJ[0])
    # the gradient through the link Function's closed-form backward
    Yt = torch.as_tensor(Y).requires_grad_(True)
    Xg, lg = b.inverse_and_log_det(Yt)
    (g,) = torch.autograd.grad((Xg ** 2).sum() + lg.sum(), Yt)
    gj = jax.jit(jax.grad(lambda V: jnp.sum(jb.inverse_and_log_det(V)[0] ** 2)
                          + jnp.sum(jb.inverse_and_log_det(V)[1])))(jnp.asarray(Y))
    _close(g, np.triu(np.asarray(gj), 1))


def test_vec_corr_forward_unchanged_by_the_flag():
    """The vector form keeps its atanh first row (the default of the
    flag): the same value as the matrix form's asinh, in other steps."""
    from tpu_bijectors_torch.bijectors.corr import _link_chol_lkj
    from tpu_bijectors_torch.utils import cholesky_upper

    K = 5
    X, _ = tbt.VecCorrBijector().inverse_and_log_det(
        torch.as_tensor(np.random.default_rng(2).standard_normal((3, 10))))
    W = cholesky_upper(X)
    assert torch.equal(tbt.VecCorrBijector().forward(X), triu_to_vec(_link_chol_lkj(W), 1))
    _close(_link_chol_lkj(W, first_row_atanh=False), _link_chol_lkj(W))
    _close(tbt.VecCorrBijector().forward(X), jax.jit(tb.VecCorrBijector().forward)(jnp.asarray(X.numpy())))
    assert K == X.shape[-1]


# ---------------------------------------------------------------------------
# bijector_from_spec over a nested spec
# ---------------------------------------------------------------------------

def test_bijector_from_spec_nested():
    spec = {"type": "Chain", "children": [
        {"type": "Stacked", "ranges_in": ((0, 2), (2, 2)), "children": [
            {"type": "Block", "ndims": 1, "inner": {"type": "Shift", "params": {"a": _A2}}},
            {"type": "Permute", "perm": (1, 0)}]},
        {"type": "Invert", "inner": {"type": "TriangularLinearMap", "lower": False,
                                     "params": {"T": np.triu(np.full((4, 4), 0.3)) + np.eye(4)}}},
        {"type": "LinearMap", "params": {"A": np.eye(4) + 0.1 * np.arange(16.0).reshape(4, 4) / 16}},
        {"type": "Block", "ndims": 1, "inner": {"type": "LeakyReLU", "params": {"alpha": 0.5}}}]}
    jb, b = _both(spec)
    assert isinstance(b, tbt.Chain) and len(b.transforms) == 4
    x = _rng().standard_normal((6, 4))
    y, ld = b.forward_and_log_det(torch.as_tensor(x))
    yj, ldj = jb.forward_and_log_det(jnp.asarray(x))
    _close(y, yj)
    _close(ld, ldj)
    _close(b.inverse(y), x)
    _close(_jac_logdet(b.forward, torch.as_tensor(x[1])), ld[1])
    assert b == bijector_from_spec(spec, **F64)
