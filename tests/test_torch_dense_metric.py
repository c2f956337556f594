"""The port's dense metric and per-chain kernels against the JAX package,
float64 on the CPU.

Pieces on the same numpy or JAX draws (1e-12): the dense Welford
accumulators, the dense M^-1 p and kinetic energy, the momentum given its
standard normal in both layouts, and one `hmc_kernel_batched` transition in
both layouts and both metrics given the same momentum, jitter and accept
uniforms. Whole runs with the JAX tests' own tolerances: NUTS with the
dense metric on the correlated Gaussian (per-chain, batch-major and
transposed kernels), and `Model.sample(kernel='nuts')` and
`kernel='hmc'` on the per-example density of the Beta-Binomial model; the
sampler's metric and `inv_mass0` validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bijectors.infer import adapt as jadapt
from tpu_bijectors.infer import hmc as jhmc
from tpu_bijectors.infer import hmc_batched as jhb
from tpu_bijectors.infer import init_sampler as jinit_sampler

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists
from tpu_bijectors_torch.infer import adapt, hmc, hmc_batched, sampler

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd(rng, d):
    A = rng.standard_normal((d, d))
    return A @ A.T / d + 0.5 * np.eye(d)


def test_welford_cov_matches_jax(rng):
    s, js = adapt.welford_cov_init(4, F64), jadapt.welford_cov_init(4, jnp.float64)
    for _ in range(5):
        xs = rng.standard_normal((9, 4)) @ np.linalg.cholesky(_spd(rng, 4)).T + 2.0
        s = adapt.welford_cov_update_batch(s, torch.as_tensor(xs))
        js = jadapt.welford_cov_update_batch(js, jnp.asarray(xs))
    for got, ref in zip(s, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for reg in (True, False):
        np.testing.assert_allclose(adapt.welford_covariance(s, reg).numpy(),
                                   np.asarray(jadapt.welford_covariance(js, reg)), **TOL)


def test_dense_inverse_mass_kinetic_and_momentum_match_jax(rng):
    """M^-1 p and the kinetic energy on rows (leading axes too); the momentum
    L^-T z from the JAX draw's z, batch-major and transposed."""
    im = _spd(rng, 5)
    p = rng.standard_normal((7, 5))
    jim = jnp.asarray(im)
    np.testing.assert_allclose(hmc.apply_inv_mass(torch.as_tensor(im), torch.as_tensor(p)),
                               np.asarray(jhmc.apply_inv_mass(jim, jnp.asarray(p))), **TOL)
    p3 = p.reshape(7, 1, 5)
    np.testing.assert_allclose(hmc.kinetic(torch.as_tensor(p3), torch.as_tensor(im)),
                               np.asarray(jhmc.kinetic(jnp.asarray(p3), jim)), **TOL)
    key = jax.random.PRNGKey(4)
    q = jnp.zeros((7, 5))
    z = np.array(jax.random.normal(key, q.shape, jnp.float64))
    np.testing.assert_allclose(hmc.momentum_from_z(torch.as_tensor(z), torch.as_tensor(im)),
                               np.asarray(jax.jit(jhmc.sample_momentum)(key, q, jim)), **TOL)
    L = hmc_batched._Layout(True)
    zt = np.array(jax.random.normal(key, q.T.shape, jnp.float64))
    np.testing.assert_allclose(
        L.momentum_from_z(torch.as_tensor(zt), torch.as_tensor(im)),
        np.asarray(jax.jit(jhb._Layout(True).momentum)(key, q.T, jim)), **TOL)
    np.testing.assert_allclose(L.aim(torch.as_tensor(im), torch.as_tensor(p.T)),
                               np.asarray(jhb._Layout(True).aim(jim, jnp.asarray(p.T))), **TOL)
    # the momentum's covariance is M = inv(inv_mass)
    big = hmc.sample_momentum(torch.Generator().manual_seed(0), torch.zeros(200000, 5, dtype=F64),
                              torch.as_tensor(im))
    np.testing.assert_allclose(np.cov(big.numpy().T), np.linalg.inv(im), atol=0.03)


_PREC = np.array([[2.0, 0.6, 0.1], [0.6, 1.0, -0.3], [0.1, -0.3, 0.8]])


def _gauss(transposed):
    P, jP = torch.as_tensor(_PREC), jnp.asarray(_PREC)
    if transposed:
        return (lambda v: -0.5 * torch.sum(v * (P @ v), 0),
                lambda v: -0.5 * jnp.sum(v * (jP @ v), 0))
    return (lambda v: -0.5 * torch.sum((v @ P) * v, -1),
            lambda v: -0.5 * jnp.sum((v @ jP) * v, -1))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_hmc_transition_matches_jax(rng, transposed, dense):
    """One hmc_kernel_batched transition on the same draws (z from the
    momentum key, the jitter and accept uniforms from theirs)."""
    f, jf = _gauss(transposed)
    C, d = 6, 3
    q = rng.standard_normal((d, C) if transposed else (C, d))
    im = _spd(rng, d) if dense else rng.uniform(0.5, 1.5, d)
    key = jax.random.PRNGKey(9)
    jk = jax.jit(jhb.hmc_kernel_batched(jf, n_leapfrog=5, jitter=0.3, transposed=transposed))
    lp, g = hmc_batched._batched_logp_and_grad(f)(torch.as_tensor(q))
    ref = jk(key, jnp.asarray(q), jnp.asarray(lp.numpy()), jnp.asarray(g.numpy()),
             jnp.asarray(0.4), jnp.asarray(im))
    k_mom, k_acc, k_jit = jax.random.split(key, 3)
    draws = (jax.random.normal(k_mom, q.shape, jnp.float64),
             jax.random.uniform(k_jit, (C,), jnp.float64),
             jax.random.uniform(k_acc, (C,), jnp.float64))
    got = hmc_batched._hmc_transition(
        hmc_batched._batched_logp_and_grad(f), hmc_batched._Layout(transposed),
        torch.as_tensor(q), lp, g, torch.tensor(0.4, dtype=F64), torch.as_tensor(im),
        *(torch.as_tensor(np.array(a)) for a in draws), 5, 0.3)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for a, b in zip(got[3], ref[3]):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b).astype(np.float64), **TOL)


@pytest.mark.parametrize("name", ["nuts", "hmc"])
def test_single_chain_kernels_are_the_batched_on_a_block_of_one(rng, name):
    """hmc.nuts_kernel and hmc.hmc_kernel on a per-example density: the
    batched kernels on the (1, dim) block of the lifted density, the same
    draws from the same generator state."""
    P = torch.as_tensor(_PREC)

    def logp(v):
        return -0.5 * v @ P @ v

    q = torch.as_tensor(rng.standard_normal(3))
    lp, g = hmc_batched._batched_logp_and_grad(
        lambda v: -0.5 * torch.sum((v @ P) * v, -1))(q[None])
    im = torch.as_tensor(_spd(rng, 3))
    if name == "nuts":
        one = hmc.nuts_kernel(logp, max_depth=5)
        block = hmc_batched.nuts_kernel_batched(torch.func.vmap(logp), max_depth=5)
    else:
        one = hmc.hmc_kernel(logp, n_leapfrog=7)
        block = hmc_batched.hmc_kernel_batched(torch.func.vmap(logp), n_leapfrog=7)
    got = one(torch.Generator().manual_seed(3), q, lp[0], g[0], torch.tensor(0.3, dtype=F64),
              im)
    ref = block(torch.Generator().manual_seed(3), q[None], lp, g, torch.tensor(0.3, dtype=F64),
                im)
    assert got[0].shape == (3,) and got[1].shape == ()
    for a, b in zip(got[:3] + tuple(got[3]), ref[:3] + tuple(ref[3])):
        assert torch.equal(a, b[0])


def test_metric_and_inv_mass0_validation_as_jax():
    def lp(q):
        return -0.5 * torch.sum(q * q)

    q0 = torch.zeros((4, 3), dtype=F64)
    g = torch.Generator()
    st = sampler.init_sampler(lp, g, q0, metric="dense")
    assert st.inv_mass.shape == (3, 3) and st.welford.m2.shape == (3, 3)
    assert torch.equal(st.grad, torch.zeros_like(q0))  # the per-chain density, lifted
    with pytest.raises(ValueError, match="inv_mass0"):
        sampler.init_sampler(lp, g, q0, metric="dense", inv_mass0=torch.ones(3))
    with pytest.raises(ValueError, match="inv_mass0"):
        jinit_sampler(lambda q: -0.5 * jnp.sum(q * q), jax.random.PRNGKey(0),
                      jnp.zeros((4, 3)), metric="dense", inv_mass0=jnp.ones(3))
    with pytest.raises(ValueError, match="metric"):
        sampler.init_sampler(lp, g, q0, metric="bogus")


# ---------------------------------------------------------------------------
# whole runs, in distribution (the JAX tests' tolerances)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["nuts", "nuts_batched", "nuts_batched_t"])
def test_dense_nuts_correlated_gaussian(kernel):
    """rho = 0.95 (per-chain, tests/test_inference.py::
    test_nuts_dense_metric_correlated_gaussian) and rho = 0.9 (the batched
    kernels' cases of test_nuts_batched(_t)_kernel_matches_moments), with
    their tolerances on runs three quarters as long: the adapted dense
    inverse mass recovers the covariance, the draws' moments stay
    exact."""
    rho = 0.95 if kernel == "nuts" else 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]])
    P = torch.as_tensor(np.linalg.inv(cov))
    if kernel == "nuts":
        def logp(v):
            return -0.5 * v @ P @ v
        chains, warmup, kept = 8, 400, 600
    elif kernel == "nuts_batched":
        def logp(v):
            return -0.5 * torch.sum((v @ P) * v, -1)
        chains, warmup, kept = 16, 300, 400
    else:
        def logp(v):
            return -0.5 * torch.sum(v * (P @ v), 0)
        chains, warmup, kept = 16, 300, 400
    g = torch.Generator().manual_seed(21)
    q0 = 0.1 * torch.randn((chains, 2), generator=g, dtype=F64)
    samples, state, stats = sampler.warmup_and_sample(
        logp, g, q0, n_warmup=warmup, n_samples=kept, kernel=kernel, metric="dense")
    s = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.12)
    assert int(stats.diverging.sum()) == 0
    if kernel == "nuts":
        np.testing.assert_allclose(s.mean(0), 0.0, atol=0.08)
        assert state.inv_mass.shape == (2, 2)
        np.testing.assert_allclose(state.inv_mass.numpy(), cov, atol=0.25)


def _beta_binomial():
    return tbt.Model(
        dists.NamedProduct.of(p=dists.Beta(2.0, 2.0, device="cpu", dtype=F64)),
        loglik=lambda x: 17 * torch.log(x["p"]) + 33 * torch.log1p(-x["p"]),
        device="cpu",
    )


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_model_sample_per_example_kernels(kernel):
    """Model.sample(kernel='nuts' | 'hmc') on the per-example density: the
    conjugate Beta(19, 35) posterior's mean within 5 standard errors of 500
    effective draws (tests/test_inference.py::test_nuts_beta_binomial's
    bound), and the per-example density matches the JAX package's."""
    from tpu_bijectors import dists as jd
    from tpu_bijectors.infer import Model as JModel

    model = _beta_binomial()
    jm = JModel(priors=jd.NamedProduct.of(p=jd.Beta(2.0, 2.0)),
                loglik=lambda x: 17 * jnp.log(x["p"]) + 33 * jnp.log1p(-x["p"]))
    v = torch.tensor([0.3], dtype=F64, requires_grad=True)
    lp = model.logdensity_fn()(v)
    (g,) = torch.autograd.grad(lp, v)
    jlp, jg = jax.value_and_grad(jm.logdensity_fn())(jnp.asarray([0.3]))
    assert lp.shape == ()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    g = torch.Generator().manual_seed(7)
    kw = dict(n_leapfrog=6) if kernel == "hmc" else {}
    samples, _, stats = model.sample(g, n_chains=8, n_warmup=200, n_samples=300, kernel=kernel,
                                     **kw)
    p = samples["p"].numpy()
    assert p.shape == (300, 8)
    a, b = 19.0, 35.0
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    np.testing.assert_allclose(p.mean(), a / (a + b), atol=5 * np.sqrt(var / 500))
    assert int(stats.diverging.sum()) == 0
