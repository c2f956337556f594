"""The PyTorch port's distributions, bijectors and registry against the JAX
package, its extreme-state robustness, its device rule, and its import
boundary. Same numpy inputs, float64 on the CPU."""

import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_bijectors as tb
from tpu_bijectors import dists as jd
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch.bijectors import Identity, SimplexBijector, Truncated, VecCorrBijector

CPU64 = dict(device="cpu", dtype=torch.float64)
ROOT = Path(__file__).resolve().parents[1]


def _families():
    """(JAX distribution, port distribution, sampler of constrained x)."""
    alpha = np.asarray([1.3, 2.0, 0.8, 1.1])
    return {
        "Normal": (jd.Normal(0.4, 1.7), td.Normal(0.4, 1.7, **CPU64),
                   lambda r: r.standard_normal(7)),
        "LogNormal": (jd.LogNormal(-0.3, 0.8), td.LogNormal(-0.3, 0.8, **CPU64),
                      lambda r: np.exp(r.standard_normal(7))),
        "Dirichlet": (jd.Dirichlet(jnp.asarray(alpha)), td.Dirichlet(alpha, **CPU64),
                      lambda r: r.dirichlet(alpha, 7)),
        "LKJ": (jd.LKJ(4, 2.5), td.LKJ(4, 2.5, **CPU64),
                lambda r: np.array(jd.LKJ(4, 2.5).sample(jax.random.PRNGKey(1), (7,)))),
    }


def test_golden_logpdf_with_trans_lognormal():
    e = torch.tensor(math.e, dtype=torch.float64)
    got = tbt.logpdf_with_trans(td.LogNormal(**CPU64), e, True)
    np.testing.assert_allclose(float(got), -1.4189385332046727, rtol=1e-15)


@pytest.mark.parametrize("transform", [False, True])
@pytest.mark.parametrize("family", list(_families()))
def test_logpdf_with_trans_matches_jax(rng, family, transform):
    jdist, tdist, draw = _families()[family]
    x = draw(rng)
    ref = np.asarray(tb.logpdf_with_trans(jdist, jnp.asarray(x), transform))
    got = tbt.logpdf_with_trans(tdist, torch.as_tensor(x), transform)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-11, atol=1e-11)


def test_registry_links():
    assert type(tbt.bijector(td.Normal(**CPU64))) is Identity
    b = tbt.bijector(td.LogNormal(**CPU64))
    assert type(b) is Truncated and b.lower_finite and not b.upper_finite and b.lb == 0.0
    assert type(tbt.bijector(td.Dirichlet(np.ones(3), **CPU64))) is SimplexBijector
    assert type(tbt.bijector(td.LKJ(3, **CPU64))) is VecCorrBijector


@pytest.mark.parametrize("K", [2, 6])
def test_simplex_bijector_matches_jax(rng, K):
    x = rng.dirichlet(np.ones(K) * 0.9, 11)
    y = 2.0 * rng.standard_normal((11, K - 1))
    jb, tbij = tb.SimplexBijector(), SimplexBijector()
    for ref, got in (
        (jb.forward_and_log_det(jnp.asarray(x)), tbij.forward_and_log_det(torch.as_tensor(x))),
        (jb.inverse_and_log_det(jnp.asarray(y)), tbij.inverse_and_log_det(torch.as_tensor(y))),
    ):
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-13)


def test_vec_corr_bijector_matches_jax(rng):
    y = 1.5 * rng.standard_normal((9, 10))  # K = 5
    jb, tbij = tb.VecCorrBijector(), VecCorrBijector()
    X_j, ld_j = jb.inverse_and_log_det(jnp.asarray(y))
    X_t, ld_t = tbij.inverse_and_log_det(torch.as_tensor(y))
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=1e-12)
    y2, ld2 = tbij.forward_and_log_det(X_t)
    np.testing.assert_allclose(y2.numpy(), y, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ld2.numpy(), -ld_t.numpy(), rtol=1e-9)
    factor_ld, _ = tbij.inverse_log_det_and_factor_only(torch.as_tensor(y))
    np.testing.assert_allclose(factor_ld.numpy(), ld_t.numpy(), rtol=1e-13)


# ---------------------------------------------------------------------------
# 1e10 jumps (tests/test_linked_robustness.py, on the port's families)
# ---------------------------------------------------------------------------


def _robust_pair():
    d = jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.0, 2.0), 2),
        sigma=jd.IIDProduct(jd.LogNormal(0.0, 0.5), 2),
        w=jd.Dirichlet(jnp.ones(6)),
        corr=jd.LKJ(4, 2.0),
    )
    t = td.NamedProduct.of(
        mu=td.IIDProduct(td.Normal(0.0, 2.0, **CPU64), 2),
        sigma=td.IIDProduct(td.LogNormal(0.0, 0.5, **CPU64), 2),
        w=td.Dirichlet(np.ones(6), **CPU64),
        corr=td.LKJ(4, 2.0, **CPU64),
    )
    return junconstrain(d), tbt.unconstrain(t, device="cpu")


def test_linked_logdensity_1e10_jumps_no_nan(rng):
    u_j, u_t = _robust_pair()
    v = torch.as_tensor(1e10 * rng.standard_normal((100, u_t.linked_vec_length)))
    vr = v.clone().requires_grad_(True)
    lp = u_t.linked_logdensity(vr)
    (g,) = torch.autograd.grad(lp.sum(), vr)
    assert not torch.isnan(lp).any() and not torch.isnan(g).any()
    lpt = u_t._linked_logdensity_t_children(v.T)
    np.testing.assert_allclose(lpt.numpy(), lp.detach().numpy(), rtol=1e-12)


def test_fused_1e10_jumps_finite_and_match_jax(rng):
    u_j, u_t = _robust_pair()
    vT = 1e10 * rng.standard_normal((u_t.linked_vec_length, 16))
    v = torch.as_tensor(vT).requires_grad_(True)
    lp = u_t.linked_logdensity_t(v)
    (g,) = torch.autograd.grad(lp.sum(), v)
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
    ref = np.asarray(jfk.mega_logdensity_t(u_j, jnp.asarray(vT), interpret=True))
    np.testing.assert_allclose(lp.detach().numpy(), ref, rtol=1e-12)


# ---------------------------------------------------------------------------
# the device rule and the import boundary
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    d = td.Normal(0.0, 1.0, **CPU64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbt.Model(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbt.unconstrain(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.Normal(0.0, 1.0)


def test_model_parts_not_ported_raise():
    d = td.Normal(0.0, 1.0, **CPU64)
    g = torch.Generator().manual_seed(0)
    # tempering's chain-sharded run takes a process group (`group`), not
    # the JAX package's `axis_name` (ADVI's flow posterior, the
    # laplace/pathfinder inits and the shard layer, once the examples
    # here, are ported)
    from tpu_bijectors_torch.infer import run_parallel_tempering

    with pytest.raises(TypeError, match="axis_name"):
        run_parallel_tempering(lambda v: -v.sum(-1), lambda v: -v.sum(-1), g,
                               torch.zeros((4, 1), **CPU64), axis_name="chains")
    assert tbt.Model(d, device="cpu").sample(g, n_chains=2, n_warmup=0, n_samples=1,
                                             init="laplace")[0].shape == (1, 2)
    # a family the port does not have (VonMises, once the example here, is
    # ported, as is every family of the JAX package)
    with pytest.raises(NotImplementedError):
        tbt.dist_from_spec({"type": "NoSuchFamily", "params": {}}, **CPU64)


def test_bare_leaf_with_a_likelihood_samples_as_in_jax(rng):
    """A bare Normal(0, 1) leaf with the likelihood x has no fused plan, so
    Model.sample(kernel='auto') runs the batch-major NUTS, as the JAX
    package does. Its density and gradient match the JAX package's
    (1e-12), and the draws match the posterior N(1, 1) of both packages:
    the mean within 5 MCSE, R-hat <= 1.1."""
    from tpu_bijectors.infer import Model as JModel

    from tpu_bijectors_torch import diagnostics

    jm = JModel(priors=jd.Normal(0.0, 1.0), loglik=lambda x: x)
    tm = tbt.Model(td.Normal(0.0, 1.0, **CPU64), loglik=lambda x: x, device="cpu")
    v = 1.5 * rng.standard_normal((9, 1))
    lp, g = tm.batched_logdensity_fn().value_and_grad_fn(torch.as_tensor(v))
    jf = jm.batched_logdensity_fn()
    jlp, jg = jax.vmap(jax.value_and_grad(lambda a: jf(a[None])[0]))(jnp.asarray(v))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12)
    draws, _, stats = tm.sample(
        torch.Generator().manual_seed(0), n_chains=8, n_warmup=100, n_samples=100,
        max_depth=5, constrained=False,
    )
    assert draws.shape == (100, 8, 1) and int(stats.diverging.sum()) == 0
    assert float(diagnostics.rhat(draws).max()) <= 1.1
    mean = float(draws.mean())
    assert abs(mean - 1.0) <= 5.0 * float(diagnostics.mcse_mean(draws)[0])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "tpu_bijectors_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in _imports(f)
        if m.split(".")[0] in ("jax", "jaxlib", "tpu_bijectors")
    ]
    assert bad == []
