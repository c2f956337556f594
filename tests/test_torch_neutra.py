"""The port's ADVI flow posterior and NeuTra against the JAX package,
float64 on the CPU.

On the same weights (carried across by `bijector_from_spec`, see
test_torch_flows.jax_spec) and inputs: `neutra_logdensity` on a batch and
on one event (1e-10), and three ADVI steps of a `FlowPosterior` on a MAF
stack with the JAX package's own eps draws, for 'elbo' and 'iwelbo': the
losses and every weight after Adam (1e-10), as
tests/test_torch_smc_advi.py holds `advi._fit` for the Gaussians. The
errors both packages raise for a flow with 'stl' or transposed=True.
Whole runs of the port against exact answers (the cases of
tests/test_neutra.py, test_nsf.py and the flow cases of
test_inference.py and test_evidence.py, sized for the CPU): NeuTra on a
small funnel (the fit's loss near 0, Var(y) = 9), the one-call
`neutra_sample` on a prior-only Model with its flow reused, an NSF
transport's fit, ADVI with a planar stack and IW-ELBO with a MAF.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flows import jax_spec

from tpu_bijectors import flows as jflows
from tpu_bijectors.infer import FlowPosterior as JFlowPosterior
from tpu_bijectors.infer import fit_advi as jfit_advi
from tpu_bijectors.infer import neutra_logdensity as j_neutra_logdensity

from tpu_bijectors_torch import bijector_from_spec, dists, flows
from tpu_bijectors_torch.bijectors import Chain
from tpu_bijectors_torch.infer import (
    FlowPosterior,
    Model,
    advi,
    fit_advi,
    fit_neutra_flow,
    neutra_logdensity,
    neutra_sample,
    warmup_and_sample,
)

TOL = dict(rtol=1e-10, atol=1e-10)
F64 = torch.float64
KW = dict(device="cpu", dtype=F64)
L2P = math.log(2.0 * math.pi)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def optim_ready():
    """One Adam step on a scratch tensor: torch.optim's first step in a
    process imports torch.distributed.tensor (2-3 s), paid here once rather
    than inside the first test that trains."""
    p = torch.zeros(1, dtype=F64, requires_grad=True)
    opt = torch.optim.Adam([p])
    p.sum().backward()
    opt.step()


def _funnel(lib):
    """Neal's funnel in one library: y ~ N(0, 3); x_i | y ~ N(0, exp(y/2))."""

    def logp(v):
        y, x = v[..., 0], v[..., 1:]
        lp_y = -0.5 * (y / 3.0) ** 2 - math.log(3.0) - 0.5 * L2P
        z = x * lib.exp(-y[..., None] / 2.0)
        return lp_y + lib.sum(-0.5 * z * z - y[..., None] / 2.0 - 0.5 * L2P, -1)

    logp.batch_capable = True
    return logp


def _carry(jflow):
    return bijector_from_spec(jax_spec(jflow), **KW)


def test_neutra_logdensity_matches_jax():
    """logp_z(z) = logp(flow(z)) + logdetJ on the same MAF weights, batched
    and on one event, with a finite gradient."""
    jflow = jflows.maf_stack(jax.random.PRNGKey(23), 3, n_layers=2, hidden=8, dtype=jnp.float64)
    flow = _carry(jflow)
    z = 0.5 * np.random.default_rng(1).standard_normal((7, 3))
    jlz = jax.jit(lambda z: j_neutra_logdensity(_funnel(jnp), jflow)(z))
    lz = neutra_logdensity(_funnel(torch), flow)
    np.testing.assert_allclose(lz(torch.as_tensor(z)).numpy(), np.asarray(jlz(z)), **TOL)
    np.testing.assert_allclose(float(lz(torch.as_tensor(z[0]))), float(jlz(z[0])), **TOL)
    zz = torch.as_tensor(z[0]).requires_grad_(True)
    (g,) = torch.autograd.grad(lz(zz), zz)
    assert bool(torch.isfinite(g).all())


def _jax_eps(key, n_steps, shape):
    """fit_advi's draws: normal(k, shape) for k in split(key, n_steps), in
    one jitted call."""
    draws = jax.jit(lambda k: jax.vmap(lambda kk: jax.random.normal(kk, shape, jnp.float64))(
        jax.random.split(k, n_steps)))(key)
    return [torch.as_tensor(np.array(d)) for d in draws]


@pytest.mark.parametrize("estimator", ["elbo", "iwelbo"])
def test_flow_posterior_adam_steps_match_jax(estimator, optim_ready):
    """Three Adam steps of FlowPosterior(maf_stack) on a correlated Gaussian
    target, on the JAX package's eps draws: the losses and the weights
    (1e-10)."""
    rho = 0.7
    prec = np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]]))
    mean = np.array([1.0, -2.0])

    def jlogp(v):
        d = v - mean
        return -0.5 * jnp.einsum("...i,ij,...j->...", d, prec, d)

    def logp(v):
        d = v - torch.as_tensor(mean)
        return -0.5 * torch.einsum("...i,ij,...j->...", d, torch.as_tensor(prec), d)

    jlogp.batch_capable = logp.batch_capable = True
    jflow = jflows.maf_stack(jax.random.PRNGKey(9), 2, n_layers=2, hidden=8, dtype=jnp.float64)
    key = jax.random.PRNGKey(5)
    n_mc, n_iw = 8, 4
    res = jax.jit(lambda f: jfit_advi(jlogp, key, 2, q=JFlowPosterior(f), n_steps=3, n_mc=n_mc,
                                      learning_rate=5e-3, dtype=jnp.float64,
                                      estimator=estimator, n_iw=n_iw))(jflow)
    n = n_mc * n_iw if estimator == "iwelbo" else n_mc
    got = advi._fit(FlowPosterior(_carry(jflow)), logp, advi._adam(5e-3),
                    _jax_eps(key, 3, (n, 2)), estimator, False, n_iw)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(res.losses), **TOL)
    params = flows.flow_parameters(got.q.flow)
    leaves = jax.tree_util.tree_leaves(res.q.flow)
    assert len(params) == len(leaves) == 12
    for p, leaf in zip(params, leaves):
        np.testing.assert_allclose(p.numpy(), np.asarray(leaf), **TOL)


def test_flow_posterior_errors_as_jax():
    jflow = jflows.maf_stack(jax.random.PRNGKey(0), 2, n_layers=1, hidden=4, dtype=jnp.float64)

    def jlogp(v):
        return -0.5 * jnp.sum(v * v, -1)

    def logp(v):
        return -0.5 * torch.sum(v * v, -1)

    jlogp.batch_capable = logp.batch_capable = True
    for kw, match in ((dict(estimator="stl"), "Gaussian families only"),
                      (dict(transposed=True), "Gaussian families only")):
        with pytest.raises(ValueError, match=match):
            fit_advi(logp, torch.Generator(), 2, q=FlowPosterior(_carry(jflow)), **kw)
        with pytest.raises(ValueError, match=match):
            jfit_advi(jlogp, jax.random.PRNGKey(0), 2, q=JFlowPosterior(jflow), **kw)


@pytest.fixture(scope="module")
def funnel_fit():
    """A MAF transport fitted to the three-dimensional funnel."""
    g = torch.Generator().manual_seed(1)
    return fit_neutra_flow(_funnel(torch), g, 3, n_layers=3, hidden=16, n_steps=500, n_mc=64,
                           learning_rate=1e-2, dtype=F64, device="cpu")


def test_neutra_funnel_fit(funnel_fit):
    """The funnel's density is normalized, so the loss is KL(q || target)
    up to MC noise: near 0 at the end, and lower than at the start."""
    losses = funnel_fit.losses
    assert losses.shape == (500,) and bool(torch.isfinite(losses).all())
    assert float(losses[-100:].mean()) < 0.3
    assert float(losses[-50:].mean()) < float(losses[:50].mean())
    assert all(not p.requires_grad for p in flows.flow_parameters(funnel_fit.flow))


def test_neutra_funnel_variance(funnel_fit):
    """NUTS in z-space through the fitted flow recovers Var(y) = 9 (plain
    NUTS with one step size underestimates it in the neck)."""
    g = torch.Generator().manual_seed(5)
    lz = neutra_logdensity(_funnel(torch), funnel_fit.flow)
    z, _, stats = warmup_and_sample(lz, g, torch.randn((8, 3), generator=g, dtype=F64),
                                    n_warmup=80, n_samples=150, kernel="nuts_batched")
    with torch.no_grad():
        y = funnel_fit.flow.forward(z)[..., 0].reshape(-1)
    assert abs(float(y.mean())) < 0.35
    np.testing.assert_allclose(float(y.var()), 9.0, atol=1.8)


def test_neutra_sample_model_one_call():
    """Prior-only Model: the constrained draws have the prior's moments;
    the returned flow is reused without refitting."""
    m = Model(dists.NamedProduct.of(mu=dists.Normal(0.0, 1.0, **KW),
                                    p=dists.Beta(2.0, 3.0, **KW)), device="cpu")
    g = torch.Generator().manual_seed(23)
    samples, res, _ = neutra_sample(m, g, n_chains=8, n_warmup=80, n_samples=160,
                                    fit_kwargs=dict(n_steps=100, n_mc=32, n_layers=2, hidden=8))
    mu, p = samples["mu"].reshape(-1), samples["p"].reshape(-1)
    assert samples["mu"].shape == (160, 8)
    assert abs(float(mu.mean())) < 0.1 and abs(float(mu.std()) - 1.0) < 0.1
    assert abs(float(p.mean()) - 0.4) < 0.03 and bool(torch.all((p > 0) & (p < 1)))
    assert res.losses.shape == (100,)
    s2, res2, _ = neutra_sample(m, g, n_chains=4, n_warmup=30, n_samples=30, flow=res.flow)
    assert res2.losses.shape == (0,) and s2["mu"].shape == (30, 4)


def test_fit_neutra_flow_nsf_banana():
    """kind='nsf' trains a spline transport stably on a curved target."""

    def logp(v):
        x, y = v[..., 0], v[..., 1]
        return -0.5 * (x ** 2 / 4.0 + (y - 0.5 * x ** 2) ** 2)

    logp.batch_capable = True
    g = torch.Generator().manual_seed(3)
    res = fit_neutra_flow(logp, g, 2, kind="nsf", n_layers=2, hidden=16, n_steps=150, n_mc=32,
                          dtype=F64, device="cpu")
    assert bool(torch.isfinite(res.losses).all())
    assert float(res.losses[-50:].mean()) < float(res.losses[:50].mean())
    assert isinstance(res.flow.transforms[0], flows.MaskedAutoregressiveSpline)
    z = 0.5 * torch.randn((9, 2), generator=g, dtype=F64)
    assert bool(torch.isfinite(neutra_logdensity(logp, res.flow)(z)).all())



def _banana(v):
    x, y = v[..., 0], v[..., 1]
    return -0.5 * (x ** 2 / 4.0 + (y - 0.5 * x ** 2) ** 2)


_banana.batch_capable = True


def test_advi_planar_flow_posterior():
    """Flow-posterior ADVI on a Chain of four planar layers (the reference
    test_inference.py's config 4) against a per-example banana density
    (a lambda without `batch_capable`, lifted by vmap): the loss falls and
    stays finite."""
    g = torch.Generator().manual_seed(2)
    layers = Chain(tuple(flows.PlanarLayer.init(g, 2, **KW) for _ in range(4)))
    res = fit_advi(lambda v: _banana(v), g, 2, q=FlowPosterior(layers), n_steps=400, n_mc=32,
                   learning_rate=1e-2, dtype=F64)
    assert bool(torch.isfinite(res.losses[-100:]).all())
    assert float(res.losses[-50:].mean()) < float(res.losses[:50].mean())
    assert isinstance(res.q.flow, Chain) and len(flows.flow_parameters(res.q.flow)) == 12


def test_iwelbo_maf_flow_posterior():
    """IW-ELBO with a MAF flow (the reference test_evidence.py's case):
    stable training on the banana."""
    g = torch.Generator().manual_seed(5)
    q0 = FlowPosterior(flows.maf_stack(g, 2, n_layers=2, hidden=8, **KW))
    res = fit_advi(_banana, g, 2, q=q0, estimator="iwelbo", n_iw=8, n_steps=300, n_mc=8,
                   learning_rate=5e-3, dtype=F64)
    assert bool(torch.isfinite(res.losses[-100:]).all())
    assert float(res.losses[-100:].mean()) < float(res.losses[:50].mean())
