"""The PyTorch port's vectorization layer against the JAX package.

Same numpy inputs, float64 on the CPU: linked lengths, the composed
per-leaf transposed log-density, the batch-major linked log-density and
its gradient, and the from_linked_vec / to_linked_vec round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CPU64, spec_of
from test_torch_fused import MODELS as FUSED_MODELS

from tpu_bijectors import dists as jd
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt

MODELS = {
    **{k: FUSED_MODELS[k] for k in ("bench", "variant", "iid_mv")},
    "leaves": lambda: jd.NamedProduct.of(
        a=jd.Normal(-1.0, 0.4),
        b=jd.LogNormal(0.5, 1.2),
        w=jd.Dirichlet(jnp.asarray([0.7, 3.0])),
    ),
}


def _pair(name):
    d = MODELS[name]()
    u_t = tbt.unconstrain(tbt.dist_from_spec(spec_of(d), **CPU64), device="cpu")
    return junconstrain(d), u_t


@pytest.mark.parametrize("name", list(MODELS))
def test_linked_vec_length_matches_jax(name):
    u_j, u_t = _pair(name)
    assert u_t.linked_vec_length == u_j.linked_vec_length
    if name == "bench":
        assert u_t.linked_vec_length == 151


@pytest.mark.parametrize("name", list(MODELS))
def test_composed_transposed_matches_jax(rng, name):
    u_j, u_t = _pair(name)
    vT = 0.7 * rng.standard_normal((u_t.linked_vec_length, 33))
    ref = np.asarray(jax.jit(u_j._linked_logdensity_t_children)(jnp.asarray(vT)))
    got = u_t._linked_logdensity_t_children(torch.as_tensor(vT))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("name", list(MODELS))
def test_linked_logdensity_and_grad_match_jax(rng, name):
    u_j, u_t = _pair(name)
    v = 0.7 * rng.standard_normal((21, u_t.linked_vec_length))
    ref, ref_g = jax.jit(
        jax.value_and_grad(lambda x: jnp.sum(u_j.linked_logdensity(x)))
    )(jnp.asarray(v))
    ref = np.asarray(jax.jit(u_j.linked_logdensity)(jnp.asarray(v)))
    vt = torch.as_tensor(v).requires_grad_(True)
    lp = u_t.linked_logdensity(vt)
    (g,) = torch.autograd.grad(lp.sum(), vt)
    np.testing.assert_allclose(lp.detach().numpy(), ref, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", list(MODELS))
def test_from_and_to_linked_vec_match_jax_and_round_trip(rng, name):
    u_j, u_t = _pair(name)
    v = 0.7 * rng.standard_normal((13, u_t.linked_vec_length))
    x_j, ld_j = jax.jit(u_j.from_linked_vec)(jnp.asarray(v))
    x_t, ld_t = u_t.from_linked_vec(torch.as_tensor(v))
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=1e-12)
    assert sorted(x_t) == sorted(x_j)
    for k in x_j:
        np.testing.assert_allclose(x_t[k].numpy(), np.asarray(x_j[k]), rtol=1e-12, atol=1e-14)
    v2, ld2 = u_t.to_linked_vec(x_t)
    np.testing.assert_allclose(v2.numpy(), v, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ld2.numpy(), -ld_t.numpy(), rtol=1e-9, atol=1e-9)
    v2_j, ld2_j = jax.jit(u_j.to_linked_vec)(x_j)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ld2.numpy(), np.asarray(ld2_j), rtol=1e-10, atol=1e-10)


def test_model_constrain_and_dim(rng):
    d = MODELS["bench"]()
    model = tbt.Model(tbt.dist_from_spec(spec_of(d), **CPU64), device="cpu")
    assert model.dim() == 151
    v = 0.3 * rng.standard_normal((4, 151))
    x = model.constrain(torch.as_tensor(v))
    assert x["corr"].shape == (4, 16, 16) and x["w"].shape == (4, 16)
    np.testing.assert_allclose(x["w"].sum(-1).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(
        torch.diagonal(x["corr"], dim1=-2, dim2=-1).numpy(), 1.0, rtol=1e-12
    )
