"""The port's flows against the JAX package, float64 on the CPU.

Every layer is made by the JAX package (its own `init`), carried across
by `bijector_from_spec` (`jax_spec` below: each array field as a numpy
array, the MADE masks included), and both packages run it on the same
numpy inputs from a seed: forward, inverse and log-det within 1e-10, for
the planar, radial, RQS (scalar and per-coordinate, at its knots and in
its identity tails), batch-norm (eval and the train step's statistics),
MAF and NSF-AR layers and their stacks, `Invert` of a stack, and
`find_alpha` on the JAX test's grid with its gradient against `jax.grad`
and `jax.jvp` (1e-9). Then the port's own pieces: `flow_parameters`
through `Chain` and `Invert`, the NSF identity at init, `flow_stack`'s
error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bijectors import flows as jflows
from tpu_bijectors.bijectors.base import Chain as JChain
from tpu_bijectors.bijectors.base import Invert as JInvert
from tpu_bijectors.bijectors.reshape import Permute as JPermute
from tpu_bijectors.flows.maf import _made_masks as j_made_masks

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import bijector_from_spec, flows
from tpu_bijectors_torch.bijectors import Chain, Invert
from tpu_bijectors_torch.flows.maf import _made_masks

TOL = dict(rtol=1e-10, atol=1e-10)
F64 = dict(device="cpu", dtype=torch.float64)


def jax_spec(b):
    """The `bijector_from_spec` spec of a JAX flow, layer or stack."""
    if isinstance(b, JChain):
        return {"type": "Chain", "children": [jax_spec(t) for t in b.transforms]}
    if isinstance(b, JInvert):
        return {"type": "Invert", "inner": jax_spec(b.bijector)}
    if isinstance(b, JPermute):
        return {"type": "Permute", "perm": tuple(b.perm)}
    spec = {"type": type(b).__name__, "params": {}}
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if f.name.startswith("mask"):
            spec["params"][f.name] = np.array(v, np.float64)
        elif isinstance(v, jax.Array):
            spec["params"][f.name] = np.array(v)
        else:
            spec[f.name] = v
    return spec


def both(jb):
    return jb, bijector_from_spec(jax_spec(jb), **F64)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@jax.jit
def _jax_maps(jb, x):
    y, ld = jb.forward_and_log_det(x)
    return (y, ld) + tuple(jb.inverse_and_log_det(y))


def same_maps(jb, b, x):
    """forward, log-det, inverse and the inverse's log-det of both packages
    at x (numpy) and at the forward's image (the JAX side one jitted
    call)."""
    y_j, ld_j, x_j, ild_j = _jax_maps(jb, jnp.asarray(x))
    y, ld = b.forward_and_log_det(torch.as_tensor(x))
    close(y, y_j)
    close(ld, ld_j)
    x_t, ild = b.inverse_and_log_det(torch.as_tensor(np.array(y_j)))
    close(x_t, x_j)
    close(ild, ild_j)
    return y, ld, x_t


KEY = jax.random.PRNGKey(23)


def _x(shape, scale=1.0, seed=7):
    return scale * np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# find_alpha
# ---------------------------------------------------------------------------

GRID = ([-10.0, -1.0, 0.0, 0.5, 3.0, 20.0], [-0.99, -0.5, 0.0, 0.5, 2.0, 10.0],
        [-1e8, -10.0, 0.0, 1.0, 1e8])


def test_find_alpha_grid_matches_jax():
    """The JAX test's grid, with the empty bracket (wt_u_hat = 0) and
    b = +-1e8: the same alpha (1e-10), every residual at 0."""
    W, U, B = np.meshgrid(*map(np.asarray, GRID), indexing="ij")
    want = jax.jit(jflows.find_alpha)(jnp.asarray(W), jnp.asarray(U), jnp.asarray(B))
    got = flows.find_alpha(*(torch.as_tensor(a) for a in (W, U, B)))
    close(got, want)
    resid = got + torch.as_tensor(U) * torch.tanh(got + torch.as_tensor(B)) - torch.as_tensor(W)
    close(resid, np.zeros_like(W), dict(rtol=0, atol=1e-7))
    assert float(flows.find_alpha(torch.tensor(1.3, dtype=torch.float64), 0.0, 5.0)) == 1.3


@pytest.mark.parametrize("point", [(0.7, 1.3, -0.2), (-3.0, -0.9, 2.0), (20.0, 10.0, 1e8),
                                   (0.5, 0.0, 1.0)])
def test_find_alpha_derivatives_match_jax(point):
    """The implicit-function rule, reverse (backward) and forward (jvp),
    against jax.grad and jax.jvp of the JAX custom JVP (1e-9)."""
    args = tuple(torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in point)
    got = torch.autograd.grad(flows.find_alpha(*args), args)
    want = jax.jit(jax.grad(jflows.find_alpha, argnums=(0, 1, 2)))(*map(jnp.float64, point))
    for g, w in zip(got, want):
        close(g, w, dict(rtol=1e-9, atol=1e-9))
    tangent = (0.3, -1.1, 0.7)
    _, jt = jax.jit(lambda p, t: jax.jvp(jflows.find_alpha, p, t))(
        tuple(map(jnp.float64, point)), tuple(map(jnp.float64, tangent)))
    prim = tuple(torch.tensor(v, dtype=torch.float64) for v in point)
    _, tt = torch.func.jvp(flows.find_alpha, prim,
                           tuple(torch.tensor(v, dtype=torch.float64) for v in tangent))
    close(tt, jt, dict(rtol=1e-9, atol=1e-9))


# ---------------------------------------------------------------------------
# the layers, on the JAX package's weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("layer", ["PlanarLayer", "RadialLayer"])
def test_planar_radial_match_jax(layer, d):
    jb, b = both(getattr(jflows, layer).init(KEY, d, jnp.float64))
    same_maps(jb, b, _x((11, d)))
    # one unbatched event
    same_maps(jb, b, _x((d,), seed=3))


def test_rqs_scalar_matches_jax_at_knots_and_tails():
    """Values inside, outside [-B, B] (the identity, log-det 0) and exactly
    at every knot (the comparison count's tie rule)."""
    jb, b = both(jflows.RationalQuadraticSpline.init(KEY, K=8, B=3.0, dtype=jnp.float64))
    knots = np.asarray(jflows.rqs._knots(jb.widths, jb.B))
    x = np.concatenate([np.linspace(-5.0, 5.0, 41), knots, [-3.0, 3.0, -1e10, 1e10]])
    y, ld, _ = same_maps(jb, b, x)
    outside = np.abs(x) >= 3.0
    close(y[outside], x[outside])
    close(ld[outside], np.zeros(outside.sum()))
    assert bool(torch.isfinite(y).all() and torch.isfinite(ld).all())
    # the inverse at the heights' knots too
    yk = np.asarray(jflows.rqs._knots(jb.heights, jb.B))
    close(b.inverse(torch.as_tensor(yk)), jax.jit(type(jb).inverse)(jb, jnp.asarray(yk)))


def test_rqs_per_dim_matches_jax():
    jb, b = both(jflows.RationalQuadraticSpline.init(KEY, K=6, B=2.0, event_dim=3,
                                                     dtype=jnp.float64))
    same_maps(jb, b, _x((9, 3), scale=1.5))


def test_batchnorm_eval_and_train_match_jax():
    from tpu_bijectors.tree import replace

    jl = replace(jflows.InvertibleBatchNorm.init(4, dtype=jnp.float64),
                 m=jnp.asarray([0.5, -0.5, 1.0, 0.0]), v=jnp.asarray([1.0, 2.0, 0.5, 3.0]),
                 logs=jnp.asarray([0.1, -0.2, 0.0, 0.3]), b=jnp.asarray([1.0, 0.0, -1.0, 0.5]))
    jl, layer = both(jl)
    x = _x((6, 4))
    same_maps(jl, layer, x)
    xt = 2.0 * _x((64, 4), seed=9) + 1.0
    y_j, ld_j, up_j = jax.jit(type(jl).forward_and_log_det_train)(jl, jnp.asarray(xt))
    y, ld, up = layer.forward_and_log_det_train(torch.as_tensor(xt))
    close(y, y_j)
    close(ld, ld_j)
    close(up.m, up_j.m)
    close(up.v, up_j.v)
    close(layer.m, jl.m)  # the layer itself keeps its statistics


@pytest.mark.parametrize("dim,hidden", [(1, 8), (5, 10), (6, 16)])
def test_made_masks_match_jax(dim, hidden):
    for m, jm in zip(_made_masks(dim, hidden), j_made_masks(dim, hidden)):
        np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("kind", ["maf", "nsf"])
def test_autoregressive_layer_matches_jax(kind):
    """One layer: inside the spline box and in its identity tails."""
    if kind == "maf":
        jl = jflows.MaskedAutoregressive.init(KEY, 6, dtype=jnp.float64)
    else:
        jl = jflows.MaskedAutoregressiveSpline.init(KEY, 6, dtype=jnp.float64)
    jl, layer = both(jl)
    x = np.concatenate([_x((8, 6), 0.8), _x((4, 6), 6.0, seed=3)])
    same_maps(jl, layer, x)


@pytest.mark.parametrize("kind", ["maf", "nsf"])
def test_stacks_and_invert_match_jax(kind):
    """maf_stack / nsf_ar_stack (Permutes between the layers) and Invert of
    the stack, the direction that fits data."""
    make = jflows.maf_stack if kind == "maf" else jflows.nsf_ar_stack
    js, st = both(make(KEY, 3, n_layers=2, hidden=12, dtype=jnp.float64))
    x = _x((16, 3), 0.9)
    same_maps(js, st, x)
    ji, inv = both(JInvert(js))
    same_maps(ji, inv, x)


# ---------------------------------------------------------------------------
# the port's own pieces
# ---------------------------------------------------------------------------


def test_flow_parameters_through_chain_and_invert():
    """The trainable tensors in the JAX package's leaf order (masks and
    Permutes hold none), and the flow rebuilt from them."""
    js = jflows.maf_stack(KEY, 3, n_layers=2, hidden=8, dtype=jnp.float64)
    st = bijector_from_spec(jax_spec(JInvert(js)), **F64)
    params = flows.flow_parameters(st)
    leaves = jax.tree_util.tree_leaves(js)
    assert len(params) == len(leaves) == 12
    for p, leaf in zip(params, leaves):
        close(p, leaf)
    doubled = flows.with_flow_parameters(st, [2.0 * p for p in params])
    assert isinstance(doubled, Invert) and isinstance(doubled.bijector, Chain)
    for p, q in zip(flows.flow_parameters(doubled), params):
        close(p, 2.0 * q)
    # masks stay the layer's constants
    layer = doubled.bijector.transforms[0]
    assert torch.equal(layer.mask1, st.bijector.transforms[0].mask1)
    with pytest.raises(ValueError):
        flows.with_flow_parameters(st, params + params)


def test_nsf_identity_at_init_bias():
    """Zero head weights give the identity inside [-B, B] (the derivative
    raws' softplus^-1(1) bias)."""
    layer = flows.MaskedAutoregressiveSpline.init(torch.Generator().manual_seed(0), 4, **F64)
    layer = dataclasses.replace(layer, w1=torch.zeros_like(layer.w1),
                                w2=torch.zeros_like(layer.w2))
    x = torch.linspace(-3.5, 3.5, 29, dtype=torch.float64)[:, None] * torch.ones(4, **F64)
    y, ld = layer.forward_and_log_det(x)
    close(y, x, dict(rtol=0, atol=1e-12))
    close(ld, torch.zeros(29, **F64), dict(rtol=0, atol=1e-12))


def test_flow_stack_kinds_and_exports():
    g = torch.Generator().manual_seed(0)
    assert isinstance(flows.flow_stack(g, 3, "maf", n_layers=2, **F64), Chain)
    assert isinstance(flows.flow_stack(g, 3, "nsf", n_layers=2, **F64), Chain)
    with pytest.raises(ValueError, match="kind"):
        flows.flow_stack(g, 3, "glow", device="cpu")
    assert set(flows.__all__) >= set(jflows.__all__)
    assert flows.Coupling is tbt.bijectors.Coupling and tbt.PlanarLayer is flows.PlanarLayer
