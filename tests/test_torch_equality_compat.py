"""The port's bijector equality, hashing and the classic function-style
aliases (`compat.py`) against the JAX package: the equality matrix of
tests/test_equality.py (pairwise distinct instances, each equal to a deep
copy of itself and its inverse to its copy's inverse), value-based tensor
fields, and `isclosedform` recursing through compositions
(tests/test_review_regressions.py), in float64 on the CPU."""

import copy

import jax.numpy as jnp
import numpy as np
import torch

import tpu_bijectors as tb

import tpu_bijectors_torch as tbt


def _t(v):
    return torch.tensor(v, dtype=torch.float64)


def _pool(T):
    """Pairwise distinct bijectors of one package; T makes its arrays."""
    B = tb if T is jnp.asarray else tbt
    return [
        B.Identity(),
        B.Block(B.Exp(), 1),
        B.Block(B.Log(), 1),
        B.Scale(2.0),
        B.Scale(3.0),
        B.Scale(T([1.0, 2.0])),
        B.Scale(T([1.0, 3.0])),
        B.Shift(2.0),
        B.Shift(T([2.0, 1.0])),
        B.Logit(1.0, 2.0),
        B.Logit(1.0, 3.0),
        B.PDBijector(),
        B.Permute((0, 2, 1)),
        B.Permute((2, 0, 1)),
        B.SimplexBijector(),
        B.Chain((B.Exp(), B.Log())),
        B.Chain((B.Log(), B.Exp())),
        B.Stacked((B.Exp(), B.Log()), ((0, 1), (1, 2))),
        B.Truncated(1.0, 2.0, lower_finite=True, upper_finite=True),
        B.Truncated(0.0, 2.0, lower_finite=True, upper_finite=True),
    ]


def _matrix(bs):
    """The equality matrix: [i][j] is bs[i] == bs[j] (a deep copy on the
    diagonal), and each diagonal inverse against its copy's."""
    eq = [[bi == (copy.deepcopy(bj) if i == j else bj) for j, bj in enumerate(bs)]
          for i, bi in enumerate(bs)]
    inv = [tb.inverse(b) == tb.inverse(copy.deepcopy(b)) if isinstance(b, tb.Bijector)
           else tbt.inverse(b) == tbt.inverse(copy.deepcopy(b)) for b in bs]
    return eq, inv


def test_equality_matrix_matches_jax():
    ours, theirs = _matrix(_pool(_t)), _matrix(_pool(jnp.asarray))
    assert ours == theirs
    eq, inv = ours
    assert all(eq[i][j] == (i == j) for i in range(len(eq)) for j in range(len(eq)))
    assert all(inv)


def test_hash_agrees_with_equality():
    """(chip_smoke.py's path 26 holds the same for bijectors on the card.)"""
    bs = _pool(_t)
    for b in bs:
        c = copy.deepcopy(b)
        assert b == c and hash(b) == hash(c)
        assert hash(tbt.inverse(b)) == hash(tbt.inverse(c))
    assert len(set(bs)) == len(bs)
    # a set and a dict key find an equal bijector with other tensors
    assert tbt.Shift(_t([1.0, 2.0])) in {tbt.Shift(_t([1.0, 2.0]))}
    assert {tbt.Chain((tbt.Scale(_t(2.0)), tbt.Exp())): 1}[tbt.Chain((tbt.Scale(2.0), tbt.Exp()))] == 1


def test_tensor_fields_are_value_based():
    a, b = tbt.Shift(_t([1.0, 2.0])), tbt.Shift(_t([1.0, 2.0]))
    assert a == b and a is not b
    assert a != tbt.Shift(_t([1.0, 2.0, 3.0]))  # shape
    assert a != tbt.Shift(1.0)  # a scalar is no shape-(2,) tensor
    assert tbt.Shift(_t([1.0, 1.0])) != tbt.Shift(1.0)
    assert tbt.Scale(_t(2.0)) == tbt.Scale(2.0)  # a 0-d tensor is its number
    assert tbt.Shift(_t([1.0, 2.0])) == tbt.Shift(np.asarray([1.0, 2.0]))
    assert tbt.Shift(_t([1.0, 2.0])) != tbt.Scale(_t([1.0, 2.0]))  # type
    assert tbt.LinearMap(torch.eye(3, dtype=torch.float64)) == tbt.LinearMap(torch.eye(3))
    assert tbt.LinearMap(torch.eye(3)) != tbt.LinearMap(2 * torch.eye(3))
    # the JAX package gives the same answers
    ja = tb.Shift(jnp.asarray([1.0, 2.0]))
    assert ja == tb.Shift(jnp.asarray([1.0, 2.0])) and ja != tb.Shift(1.0)


def test_compat_aliases_against_jax():
    spec_t = tbt.Chain((tbt.Block(tbt.Exp(), 1), tbt.LinearMap(_t([[2.0, 0.5], [0.1, 1.0]]))))
    spec_j = tb.Chain((tb.Block(tb.Exp(), 1), tb.LinearMap(jnp.asarray([[2.0, 0.5], [0.1, 1.0]]))))
    x = np.asarray([[0.3, -0.4], [1.1, 0.2]])
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for name in ("transform", "logabsdetjac"):
        np.testing.assert_allclose(getattr(tbt, name)(spec_t, xt).numpy(),
                                   np.asarray(getattr(tb, name)(spec_j, xj)), rtol=1e-12)
    y, ld = tbt.with_logabsdet_jacobian(spec_t, xt)
    yj, ldj = tb.with_logabsdet_jacobian(spec_j, xj)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-12)
    np.testing.assert_allclose(tbt.logabsdetjacinv(spec_t, y).numpy(),
                               np.asarray(tb.logabsdetjacinv(spec_j, yj)), rtol=1e-12)
    np.testing.assert_allclose(tbt.logabsdetjacinv(spec_t, y).numpy(), -ld.numpy(), rtol=1e-12)
    assert tbt.output_size(tbt.Reshape((6,), (2, 3)), (6,)) == tb.output_size(
        tb.Reshape((6,), (2, 3)), (6,)) == (2, 3)
    assert tbt.output_size(tbt.VecCorrBijector(), (4, 4)) == (6,)
    assert tbt.isinvertible(tbt.Exp()) and tbt.isinvertible(tbt.inverse(tbt.Shift(1.0)))
    assert not tbt.isinvertible(object())
    cw = tbt.columnwise(tbt.OrderedBijector())
    assert cw == tbt.Block(tbt.OrderedBijector(), 1)
    m = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 4)))
    np.testing.assert_allclose(cw.forward(m).numpy(),
                               np.asarray(tb.columnwise(tb.OrderedBijector()).forward(jnp.asarray(m.numpy()))),
                               rtol=1e-12)


class _IterativeInverse(tbt.Bijector):
    """A bijector whose inverse has no closed form (as the flows' planar
    layer's), for isclosedform."""

    closed_form_inverse = False


def test_isclosedform_recurses():
    p = _IterativeInverse()
    assert not tbt.isclosedform(tbt.Chain((tbt.inverse(p),)))
    assert not tbt.isclosedform(tbt.Block(tbt.inverse(p), 1))
    assert not tbt.isclosedform(tbt.Chain((tbt.Exp(), tbt.Block(tbt.inverse(p), 1))))
    assert tbt.isclosedform(tbt.Chain((tbt.Exp(), tbt.Shift(1.0))))
    assert tbt.isclosedform(p)  # its forward is closed
    assert tbt.isclosedform(tbt.inverse(tbt.Exp()))
    # the trait through the compositions, as the JAX package's
    assert not tbt.Chain((tbt.Exp(), p)).closed_form_inverse
    assert not tbt.Block(p, 1).closed_form_inverse
    assert tbt.Invert(p).closed_form_inverse
