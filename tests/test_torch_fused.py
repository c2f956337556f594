"""The PyTorch port's fused slab evaluation against the JAX package.

Same numpy inputs, float64 on the CPU: the port's plain slab closed form,
coefficient table, fused value, one-pass value-and-gradient and autograd
gradient against the JAX package's `_slab_segment_val_par`, `_prep` and
Pallas kernels in interpret mode. On the CPU the port's wrappers run the
plain versions of their CUDA kernels; the kernels themselves are checked
against those plain versions on the card by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bijectors import dists as jd
from tpu_bijectors.vectorize import fused_base as jfb
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import kernels
from tpu_bijectors_torch.bijectors import Truncated
from tpu_bijectors_torch.vectorize import fused_base as tfb
from tpu_bijectors_torch.vectorize import fused_kernel as tfk
from tpu_bijectors_torch.vectorize.core import LeafUnconstrainer, TreeUnconstrainer

CPU64 = dict(device="cpu", dtype=torch.float64)
RTOL, ATOL = 1e-12, 1e-10  # float64, the same closed form on both sides


def spec_of(d):
    """A JAX distribution as a `dist_from_spec` description. A
    TransformedDistribution must be `transformed(base)` (the base's registry
    bijector), which is what the spec rebuilds."""
    kind = type(d).__name__
    if kind == "NamedProduct":
        return {"type": kind, "children": {n: spec_of(c) for n, c in zip(d.names, d.components)}}
    if kind == "IIDProduct":
        return {"type": kind, "inner": spec_of(d.base), "n": d.n}
    if kind in ("ElementwiseProduct", "TransformedDistribution"):
        return {"type": kind, "inner": spec_of(d.base)}
    spec = {"type": kind, "params": {}}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if f.name.endswith("_static"):
            continue  # the JAX package's float copy of a bound parameter
        if isinstance(v, jd.Distribution):
            spec[f.name] = spec_of(v)  # a wrapper's base or components
        elif isinstance(v, (int, str)) and not isinstance(v, bool):
            spec[f.name] = v
        else:
            spec["params"][f.name] = np.asarray(v)
    return spec


MODELS = {
    # bench.py's model
    "bench": lambda: jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.0, 2.0), 8),
        sigma=jd.IIDProduct(jd.LogNormal(0.0, 0.5), 8),
        w=jd.Dirichlet(jnp.ones(16)),
        corr=jd.LKJ(16, 2.0),
    ),
    # alpha != 1, eta = 3, K = 5
    "variant": lambda: jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.3, 1.5), 3),
        sigma=jd.IIDProduct(jd.LogNormal(-0.2, 0.7), 2),
        w=jd.Dirichlet(jnp.asarray([1.3, 2.0, 0.8, 1.1, 0.6])),
        corr=jd.LKJ(5, 3.0),
    ),
    # IID blocks of structured leaves: one slab entry per copy
    "iid_mv": lambda: jd.NamedProduct.of(
        w=jd.IIDProduct(jd.Dirichlet(jnp.asarray([1.2, 0.9, 2.0])), 3),
        c=jd.IIDProduct(jd.LKJ(3, 1.5), 2),
        x=jd.Normal(0.2, 0.8),
    ),
    # a bare leaf: the fused path serves any unconstrainer, not only products
    "leaf": lambda: jd.Dirichlet(jnp.asarray([0.7, 1.9, 1.2, 3.0])),
}


def _pair(name):
    d = MODELS[name]()
    u_t = tbt.unconstrain(tbt.dist_from_spec(spec_of(d), **CPU64), device="cpu")
    return junconstrain(d), u_t


def _state(rng, dim, B=48, scale=0.6):
    return scale * rng.standard_normal((dim, B))


# ---------------------------------------------------------------------------
# the slab closed form (plain version of the kernels)
# ---------------------------------------------------------------------------


def _slab_rows(rng):
    """12 rows: 6 owned with random coefficients (sa <= 0, the closed
    form's invariant) and finite V; 3 owned with all-zero coefficients and
    3 masked (ownership 0) with random coefficients, both at V = +/-inf."""
    R, B = 12, 9
    cf = rng.standard_normal((R, jfb.NCF))
    cf[:, jfb._CI["sa"]] = -np.abs(cf[:, jfb._CI["sa"]])
    cf[:, jfb._MASK_COL] = 1.0
    cf[6:9, : jfb.NK] = 0.0
    cf[9:, jfb._MASK_COL] = 0.0
    V = rng.standard_normal((R, B))
    V[6:, ::2] = np.inf
    V[6:, 1::2] = -np.inf
    return V, cf


@pytest.mark.parametrize("mode", ["value", "partial", "both"])
@pytest.mark.parametrize("group", list(jfb._WEIGHT_OF))
def test_slab_segment_val_par_matches_jax(rng, group, mode):
    V, cf = _slab_rows(rng)
    used = frozenset(jfb._COEF_KEYS)
    kw = dict(value=mode != "partial", partial=mode != "value")
    ref = jfb._slab_segment_val_par((group,), jnp.asarray(V), jnp.asarray(cf), used, **kw)
    got = tfb._slab_segment_val_par(
        (group,), torch.as_tensor(V), torch.as_tensor(cf), used, **kw
    )
    for r, g in zip(ref, got):
        assert (r is None) == (g is None)
        if r is not None:
            assert np.all(np.isfinite(g.numpy()))
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_prep_matches_jax(rng, name):
    u_j, u_t = _pair(name)
    vT = _state(rng, u_t.linked_vec_length)
    ref = jfk._prep(u_j, jnp.asarray(vT))
    cf, _, c0sum = tfk._prep(u_t, torch.as_tensor(vT))
    np.testing.assert_allclose(cf.numpy(), np.asarray(ref[8]), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(c0sum), float(ref[12]), rtol=1e-12)


# ---------------------------------------------------------------------------
# the fused value, value-and-gradient and autograd gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_value_matches_jax_kernel(rng, name):
    u_j, u_t = _pair(name)
    vT = _state(rng, u_t.linked_vec_length)
    ref = np.asarray(jfk.mega_logdensity_t(u_j, jnp.asarray(vT), interpret=True))
    got = u_t.linked_logdensity_t(torch.as_tensor(vT))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_value_and_grad_matches_jax_kernel(rng, name):
    u_j, _ = _pair(name)
    model = tbt.Model(tbt.dist_from_spec(spec_of(MODELS[name]()), **CPU64), device="cpu")
    vT = _state(rng, model.dim())
    ref_lp, ref_g = jfk.mega_value_and_grad_t(u_j, jnp.asarray(vT), interpret=True)
    lp, g = model.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_autograd_matches_jax_vjp_kernel(rng, name):
    u_j, u_t = _pair(name)
    vT = _state(rng, u_t.linked_vec_length)
    ct = rng.standard_normal(vT.shape[1])
    ref = np.asarray(jfk.mega_vjp_t(u_j, jnp.asarray(vT), jnp.asarray(ct), interpret=True))
    v = torch.as_tensor(vT).requires_grad_(True)
    (g,) = torch.autograd.grad(u_t.linked_logdensity_t(v), v, torch.as_tensor(ct))
    np.testing.assert_allclose(g.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_cpu_wrappers_run_plain_versions_without_launching(rng):
    """A CPU tensor takes the plain version and counts no kernel launch."""
    _, u_t = _pair("variant")
    vT = torch.as_tensor(_state(rng, u_t.linked_vec_length))
    cf, _, _ = tfk._prep(u_t, vT)
    before = dict(kernels.LAUNCHES)
    ct = torch.ones(vT.shape[1], dtype=vT.dtype)
    assert torch.equal(tfk.slab_value(vT, cf), tfb.slab_value_plain(vT, cf))
    lp, g = tfk.slab_value_and_grad(vT, cf)
    lp_p, g_p = tfb.slab_value_and_grad_plain(vT, cf)
    assert torch.equal(lp, lp_p) and torch.equal(g, g_p)
    assert torch.equal(tfk.slab_vjp(vT, cf, ct), tfb.slab_vjp_plain(vT, cf, ct))
    assert kernels.LAUNCHES == before


def test_kernels_disabled_takes_composed_path_on_cpu(rng):
    """With the kernels off a CPU state takes the composed path, and
    value_and_grad_fn differentiates it (against jax.vjp of the JAX
    package's composed path)."""
    u_j, u_t = _pair("variant")
    model = tbt.Model(tbt.dist_from_spec(spec_of(MODELS["variant"]()), **CPU64), device="cpu")
    vT = _state(rng, u_t.linked_vec_length)
    kernels.enable(False)
    try:
        got = u_t.linked_logdensity_t(torch.as_tensor(vT))
        lp, g = model.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    finally:
        kernels.enable(True)
    assert torch.equal(got, u_t._linked_logdensity_t_children(torch.as_tensor(vT)))
    ref_lp, vjpf = jax.vjp(u_j._linked_logdensity_t_children, jnp.asarray(vT))
    (ref_g,) = vjpf(jnp.ones_like(ref_lp))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-10, atol=1e-12)


def test_leaf_without_slab_form_declines_and_names_the_leaf(rng):
    """A leaf with no slab form: _plan is None, a CPU state takes the
    composed path, and _prep (what every CUDA call goes through) raises
    NotImplementedError naming the leaf."""
    d = tbt.dists.Normal(0.5, 1.3, **CPU64)
    leaf = LeafUnconstrainer(d, Truncated(0.0, float("inf"), True, False), (), ())
    u = TreeUnconstrainer.build((leaf,), ("x",))
    vT = torch.as_tensor(_state(rng, 1, scale=0.3))
    assert tfk._plan(u) is None
    x = torch.exp(vT[0])
    np.testing.assert_allclose(
        u.linked_logdensity_t(vT).numpy(), (d.logpdf(x) + vT[0]).numpy(), rtol=1e-14
    )
    with pytest.raises(NotImplementedError, match="Normal"):
        tfk._prep(u, vT)
