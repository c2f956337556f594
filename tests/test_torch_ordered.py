"""`ordered(d)`, the registry's `link` / `invlink` and the monotonicity
traits through compositions, against the JAX package in float64 on the
CPU (tests/test_simplex_ordered.py:87-150 and
tests/test_review_regressions.py:208-216):

- ordered(d) on the increasing branch (an MvNormal's identity link) and the
  decreasing one (an upper-bounded IID base: the sign-flip sandwich), its
  log-density and its link's values and log-dets against the JAX package;
- the rejection sampler for a non-exchangeable base against a numpy
  rejection oracle, and the sorting fast path for an IID base;
- `linked_optic_vec` None per element (the ordered link is bidiagonal);
- the repair: joint order statistics of a base whose link is a Chain of two
  increasing maps, which raised before Chain carried the traits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_bijectors as tb
from tpu_bijectors import dists as jd

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-10, atol=1e-10)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _bases():
    """(port base, JAX base, a sorted in-support point) for each branch."""
    return {
        "increasing": (td.MvNormal(np.zeros(4), scale_diag=np.ones(4), **F64),
                       jd.MvNormal(jnp.zeros(4), scale_diag=jnp.ones(4)),
                       np.asarray([-1.0, 0.0, 0.5, 2.0])),
        "decreasing": (td.IIDProduct(td.Truncated(td.Normal(0.0, 1.0, **F64), upper=1.5), 3),
                       jd.IIDProduct(jd.Truncated(jd.Normal(0.0, 1.0), upper=1.5), 3),
                       np.asarray([-0.7, 0.2, 1.1])),
    }


@pytest.mark.parametrize("branch", ["increasing", "decreasing"])
def test_ordered_against_jax(branch):
    d, dj, x = _bases()[branch]
    od, odj = tbt.ordered(d), tb.ordered(dj)
    assert isinstance(od, tbt.OrderedDistribution) and od.support.kind == "ordered"
    flips = sum(isinstance(getattr(t, "bijector", None), tbt.SignFlip) for t in od.transform.transforms)
    assert flips == (2 if branch == "decreasing" else 0)
    unsorted = x[::-1].copy()
    for pt in (x, unsorted):
        np.testing.assert_allclose(_np(od.logpdf(torch.as_tensor(pt))),
                                   np.asarray(odj.logpdf(jnp.asarray(pt))), **TOL)
    assert float(od.logpdf(torch.as_tensor(unsorted))) == -np.inf
    b, bj = tbt.bijector(od), tb.bijector(odj)
    assert b == od.transform
    y, ld = b.forward_and_log_det(torch.as_tensor(x))
    yj, ldj = bj.forward_and_log_det(jnp.asarray(x))
    np.testing.assert_allclose(_np(y), np.asarray(yj), **TOL)
    np.testing.assert_allclose(_np(ld), np.asarray(ldj), **TOL)
    xr, ldi = b.inverse_and_log_det(y)
    np.testing.assert_allclose(_np(xr), x, **TOL)
    np.testing.assert_allclose(_np(ldi), -_np(ld), **TOL)
    # link / invlink are the registry bijector's two directions
    np.testing.assert_allclose(_np(tbt.link(od, torch.as_tensor(x))), np.asarray(tb.link(odj, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(_np(tbt.invlink(od, y)), np.asarray(tb.invlink(odj, yj)), **TOL)
    # logpdf_with_trans through the ordered link, as the JAX package's
    np.testing.assert_allclose(_np(tbt.logpdf_with_trans(od, torch.as_tensor(x), True)),
                               np.asarray(tb.logpdf_with_trans(odj, jnp.asarray(x), True)), **TOL)


def test_ordered_rejects_a_non_monotone_link():
    with pytest.raises(ValueError, match="ordered transform not supported"):
        tbt.ordered(td.Dirichlet(np.ones(3), **F64))


def test_link_and_invlink_of_a_family():
    d, dj = td.LogNormal(0.2, 0.6, **F64), jd.LogNormal(0.2, 0.6)
    x = np.asarray([0.3, 1.0, 4.0])
    np.testing.assert_allclose(_np(tbt.link(d, torch.as_tensor(x))), np.asarray(tb.link(dj, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(_np(tbt.invlink(d, tbt.link(d, torch.as_tensor(x)))), x, **TOL)


def test_register_bijector():
    class _Wrapped(td.Normal):
        pass

    @tbt.register_bijector(_Wrapped)
    def _rule(d):
        return tbt.Shift(1.0)

    try:
        assert tbt.bijector(_Wrapped(0.0, 1.0, **F64)) == tbt.Shift(1.0)
        assert tbt.bijector(td.Normal(0.0, 1.0, **F64)) != tbt.Shift(1.0)
    finally:
        from tpu_bijectors_torch.registry import _REGISTRY

        del _REGISTRY[_Wrapped]


def test_rejection_sampler_nonexchangeable():
    """For a non-exchangeable base the draw is rejection-sampled until
    sorted (ordered.jl:160-168), not sorted: held to a numpy rejection
    oracle, and apart from the sorted draw."""
    loc, scale = np.asarray([0.0, 1.5]), np.asarray([1.0, 0.25])
    base = td.MvNormal(loc, scale_diag=scale, **F64)
    od = tbt.ordered(base)
    n = 20000
    xs = _np(od.sample(torch.Generator().manual_seed(23), (n,)))
    assert np.isfinite(xs).all() and (xs[:, 1] >= xs[:, 0]).all()
    draws = np.random.default_rng(0).normal(loc, scale, size=(4 * n, 2))
    acc = draws[draws[:, 1] >= draws[:, 0]]
    np.testing.assert_allclose(xs.mean(0), acc.mean(0), atol=0.02)
    np.testing.assert_allclose(xs.std(0), acc.std(0), atol=0.02)
    srt = np.sort(_np(base.sample(torch.Generator().manual_seed(23), (n,))), axis=-1)
    assert abs(srt[:, 0].mean() - acc[:, 0].mean()) > 0.03


def test_rejection_sampler_caps_its_rounds(monkeypatch):
    """A row not accepted within the cap is NaN, the others kept."""
    import sys

    monkeypatch.setattr(sys.modules["tpu_bijectors_torch.transformed"], "MAX_REJECTION_ROUNDS", 0)
    od = tbt.ordered(td.MvNormal(np.asarray([0.0, 1.5]), scale_diag=np.asarray([1.0, 0.25]), **F64))
    xs = _np(od.sample(torch.Generator().manual_seed(1), (200,)))
    ok = np.isfinite(xs).all(-1)
    assert 0 < ok.sum() < 200 and np.isnan(xs[~ok]).all() and (xs[ok, 1] >= xs[ok, 0]).all()


def test_iid_sort_fast_path():
    od = tbt.ordered(td.IIDProduct(td.Normal(0.0, 1.0, **F64), 3))
    n = 20000
    xs = _np(od.sample(torch.Generator().manual_seed(23), (n,)))
    assert (np.diff(xs, axis=-1) >= 0).all()
    draws = np.random.default_rng(1).normal(size=(10 * n, 3))
    acc = draws[(np.diff(draws, axis=-1) >= 0).all(axis=-1)]
    np.testing.assert_allclose(xs.mean(0), acc.mean(0), atol=0.03)


def test_ordered_linked_optics_entangled():
    u = tbt.unconstrain(tbt.ordered(td.IIDProduct(td.Normal(0.0, 1.0, **F64), 3)), device="cpu")
    assert all(o is None for o in u.linked_optic_vec())
    assert u.linked_vec_length == 3


def test_traits_repair_probe():
    """Joint order statistics of transformed(LogNormal(0, 1)): the base's
    link is Chain((Truncated(0, inf), Invert(Truncated(0, inf)))), both
    increasing, so the chain is increasing; the JAX package gives
    -7.0605091234048905 on this point."""
    x = np.sort(np.random.default_rng(0).normal(size=5))
    d = td.JointOrderStatistics(tbt.transformed(td.LogNormal(0.0, 1.0, **F64)), 5)
    link = tbt.bijector(d.base)
    assert isinstance(link, tbt.Chain) and link.monotonically_increasing
    assert not link.monotonically_decreasing
    got = float(tbt.logpdf_with_trans(d, torch.as_tensor(x), True))
    assert abs(got - -7.0605091234048905) <= 1e-12
    dj = jd.JointOrderStatistics(tb.transformed(jd.LogNormal(0.0, 1.0)), 5)
    assert abs(got - float(tb.logpdf_with_trans(dj, jnp.asarray(x), True))) <= 1e-12
