"""The port's L-BFGS, MAP and Laplace approximation against the JAX package
and optax, float64 on the CPU.

L-BFGS (`infer/lbfgs.py`) against `optax.lbfgs()` on the same function:
the first 20 iterates within 1e-9 relative and each step's line-search
trials (the evaluations a step) equal, on a Rosenbrock function and on a
Dirichlet + LKJ(3) + LogNormal model's linked density. `fit_map` and
`map_laplace` on the JAX tests' cases (`tests/test_map_laplace.py`: the
Gaussian with its exact posterior and evidence, also against the JAX
package's run; the LogNormal's linked mode, Adam's best iterate, jitter
on a flat direction, a mixed-support model); the Laplace Gaussian's
methods on the JAX package's standard normals. The batched Hessian (one double
backward over dim copies of the point) against `jax.hessian` on a model
with a simplex, an LKJ(3) and a Wishart(K = 3) leaf in both PD modes,
with and without a likelihood; a second derivative through the fused
transposed density raises. `Model.sample(init='laplace')`'s starts and
inverse mass.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_fused import CPU64, spec_of

from tpu_bijectors import dists as jd
from tpu_bijectors.infer import LaplaceApprox as JLaplaceApprox
from tpu_bijectors.infer import Model as JModel
from tpu_bijectors.infer import map_laplace as jmap_laplace

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.infer import (
    fit_map,
    hmc_batched,
    laplace_approximation,
    map_laplace,
)
from tpu_bijectors_torch.infer.lbfgs import lbfgs
from tpu_bijectors_torch.infer.map_laplace import _loss_value_and_grad, hessian

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-10)
N_ITER = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# L-BFGS against optax
# ---------------------------------------------------------------------------


def _optax_run(loss, v0, n):
    """optax.lbfgs() as the JAX package's fit_map steps it: the iterates
    before each step and each step's line-search trials."""
    opt = optax.lbfgs()
    vag = optax.value_and_grad_from_state(loss)

    @jax.jit
    def step(v, st):
        value, g = vag(v, state=st)
        u, st = opt.update(g, st, v, value=value, grad=g, value_fn=loss)
        return optax.apply_updates(v, u), st, st[2].info.num_linesearch_steps

    v, st = jnp.asarray(v0), opt.init(jnp.asarray(v0))
    vs, trials = [], []
    for _ in range(n):
        vs.append(np.asarray(v))
        v, st, k = step(v, st)
        trials.append(int(k))
    return np.stack(vs), trials


def _small_model():
    return jd.NamedProduct.of(w=jd.Dirichlet(jnp.array([2.0, 3.0, 1.5])), c=jd.LKJ(3, 1.5),
                              s=jd.LogNormal(0.3, 0.7))


def _rosenbrock():
    def jf(v):
        return jnp.sum(100.0 * (v[1:] - v[:-1] ** 2) ** 2 + (1.0 - v[:-1]) ** 2)

    def tf(v):
        return -torch.sum(100.0 * (v[1:] - v[:-1] ** 2) ** 2 + (1.0 - v[:-1]) ** 2)

    return jf, tf, np.array([-1.2, 1.0, -0.5, 0.8, 1.5, 0.3])


def _model_target():
    jm = JModel(priors=_small_model())
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jm.priors), **CPU64), device="cpu")
    jfn = jm.logdensity_fn()
    v0 = 1.5 * np.random.default_rng(3).standard_normal(tm.dim())
    return (lambda v: -jfn(v)), tm.logdensity_fn(), v0


@pytest.mark.parametrize("target", ["rosenbrock", "model"])
def test_lbfgs_matches_optax(target):
    """The first 20 iterates within 1e-9 relative and the line search's
    trials a step equal; each step evaluates the loss once a trial (once
    more at the first step, which has no cached value) and reads the host
    once a trial. Trials are compared while the step's gradient exceeds
    1e-8: past that the decrease test weighs values a few ulps apart, which
    two orders of summation decide differently."""
    jloss, logp, v0 = _rosenbrock() if target == "rosenbrock" else _model_target()
    ref, trials = _optax_run(jloss, v0, N_ITER)
    hmc_batched.reset_sync_count()
    tr = lbfgs(_loss_value_and_grad(logp), torch.as_tensor(v0), N_ITER)
    np.testing.assert_allclose(tr.positions.numpy(), ref, rtol=1e-9, atol=1e-12)
    live = int(np.sum(torch.linalg.vector_norm(tr.grads, dim=1).numpy() > 1e-8))
    assert live >= 12
    assert tr.linesearch_steps[:live] == trials[:live]
    assert tr.evals == [tr.linesearch_steps[0] + 1] + tr.linesearch_steps[1:]
    assert hmc_batched.SYNCS["linesearch"] == sum(tr.linesearch_steps)


def test_lbfgs_stays_finite_past_convergence():
    """Started at the minimum (a zero gradient): every iterate stays put,
    one trial a step, no NaN."""
    def logp(v):
        return -0.5 * torch.sum((v - 2.0) ** 2)

    tr = lbfgs(_loss_value_and_grad(logp), torch.full((4,), 2.0, dtype=F64), 12)
    assert torch.equal(tr.final, torch.full((4,), 2.0, dtype=F64))
    assert bool(torch.isfinite(tr.positions).all()) and tr.linesearch_steps == [1] * 12
    # and after converging from elsewhere
    tr = lbfgs(_loss_value_and_grad(logp), torch.zeros(4, dtype=F64), 40)
    assert bool(torch.isfinite(tr.positions).all())
    np.testing.assert_allclose(tr.final.numpy(), 2.0, atol=1e-12)


# ---------------------------------------------------------------------------
# fit_map and map_laplace against the JAX package
# ---------------------------------------------------------------------------


_MU0, _S0, _Y, _S = [0.5, -1.0, 2.0], [1.0, 2.0, 0.5], [1.0, 0.0, 1.0], 0.7


def _gaussian_models():
    """tests/test_map_laplace.py's Gaussian (Laplace exact) in both packages,
    with its posterior mean and variance and evidence."""
    jy, ty = jnp.asarray(_Y), torch.as_tensor(_Y, dtype=F64)
    jm = JModel(priors=jd.NamedProduct.of(x=jd.MvNormalDiag(jnp.asarray(_MU0), jnp.asarray(_S0))),
                loglik=lambda t: jnp.sum(-0.5 * ((jy - t["x"]) / _S) ** 2 - jnp.log(_S)
                                         - 0.5 * jnp.log(2 * jnp.pi)))
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jm.priors), **CPU64),
                   loglik=lambda t: torch.sum(-0.5 * ((ty - t["x"]) / _S) ** 2 - np.log(_S)
                                              - 0.5 * np.log(2 * np.pi)), device="cpu")
    mu0, s0, y = map(np.asarray, (_MU0, _S0, _Y))
    prec = 1.0 / s0**2 + 1.0 / _S**2
    ev = np.sum(-0.5 * (y - mu0) ** 2 / (s0**2 + _S**2) - 0.5 * np.log(2 * np.pi * (s0**2 + _S**2)))
    return jm, tm, (mu0 / s0**2 + y / _S**2) / prec, 1.0 / prec, ev


def _mixed_models():
    jm = JModel(priors=jd.NamedProduct.of(mu=jd.Normal(0.0, 1.0), sigma=jd.LogNormal(0.0, 0.5),
                                          w=jd.Dirichlet(jnp.array([3.0, 4.0, 5.0]))))
    return jm, tbt.Model(tbt.dist_from_spec(spec_of(jm.priors), **CPU64), device="cpu")


def test_map_laplace_gaussian_exact():
    """Laplace is exact on the Gaussian: the port's MAP, marginal sd and
    evidence equal the posterior's, and its iterates' losses, MAP, factor
    and evidence the JAX package's map_laplace."""
    jm, tm, post_mean, post_var, ev = _gaussian_models()
    jres, jlap = jmap_laplace(jm, n_steps=60)
    res, lap = map_laplace(tm, n_steps=60)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(res.position.numpy(), np.asarray(jres.position), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(float(res.logdensity), float(jres.logdensity), rtol=1e-9)
    np.testing.assert_allclose(lap.chol_precision.numpy(), np.asarray(jlap.chol_precision),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(lap.log_evidence()), float(jlap.log_evidence()), rtol=1e-9)
    np.testing.assert_allclose(res.position.numpy(), post_mean, atol=1e-6)
    assert float(res.grad_norm) < 1e-5
    np.testing.assert_allclose(lap.marginal_sd().numpy(), np.sqrt(post_var), rtol=1e-6)
    np.testing.assert_allclose(float(lap.log_evidence()), ev, rtol=1e-6)


def test_laplace_methods_on_jax_draws(key):
    """The Laplace Gaussian's draws on the JAX package's standard normals,
    its log density (batched), evidence, covariance and marginal sd, on
    the same factor (the port's fit of the Gaussian model)."""
    _, tm, _, _, _ = _gaussian_models()
    _, lap = map_laplace(tm, n_steps=60)
    jlap = JLaplaceApprox(*(jnp.asarray(t.numpy()) for t in lap))
    ref = np.asarray(jlap.sample(key, 64))
    z = np.array(jax.random.normal(key, (64, 3), jnp.float64))
    x = lap._from_z(torch.as_tensor(z))
    np.testing.assert_allclose(x.numpy(), ref, **TOL)
    np.testing.assert_allclose(lap.logdensity(x.reshape(8, 8, 3)).numpy().ravel(),
                               np.asarray(jlap.logdensity(jnp.asarray(ref))), **TOL)
    np.testing.assert_allclose(float(lap.log_evidence()), float(jlap.log_evidence()), **TOL)
    np.testing.assert_allclose(lap.covariance().numpy(), np.asarray(jlap.covariance()), **TOL)
    np.testing.assert_allclose(lap.marginal_sd().numpy(), np.asarray(jlap.marginal_sd()), **TOL)
    g = torch.Generator().manual_seed(0)
    assert lap.sample(g, 5).shape == (5, 3)


def test_map_linked_mode_lognormal():
    """Prior-only LogNormal(mu, sig): the linked density is N(mu, sig^2),
    so the linked MAP is mu; draws constrain into the support."""
    tm = tbt.Model(tbt.dist_from_spec(
        spec_of(jd.NamedProduct.of(x=jd.LogNormal(0.8, 0.6))), **CPU64), device="cpu")
    res, lap = map_laplace(tm, n_steps=60)
    np.testing.assert_allclose(float(res.position[0]), 0.8, atol=1e-6)
    np.testing.assert_allclose(float(lap.marginal_sd()[0]), 0.6, rtol=1e-6)
    x = tm.constrain(lap.sample(torch.Generator().manual_seed(0), 64))["x"]
    assert bool((x > 0).all())


def test_fit_map_adam_best_iterate():
    """learning_rate runs Adam (optax.adam's update: tests/test_torch_smc_
    advi.py) to the optimum, and the best iterate, not the last, is
    returned."""
    def logp(v):
        return -0.5 * torch.sum((v - 3.0) ** 2)

    res = fit_map(logp, torch.zeros(2, dtype=F64), n_steps=400, learning_rate=0.1)
    np.testing.assert_allclose(res.position.numpy(), 3.0, atol=1e-3)
    assert float(res.logdensity) >= float(-res.losses.min())
    best = int(torch.argmin(res.losses))
    assert float(res.logdensity) == max(float(-res.losses[best]), float(res.logdensity))
    with pytest.raises(ValueError, match="either"):
        fit_map(logp, torch.zeros(2, dtype=F64), optimizer=lambda p: None, learning_rate=0.1)


def test_laplace_jitter_rescues_flat_direction():
    """A flat coordinate makes H singular: the plain factor is NaN (as the
    JAX package's is), the jittered one diag(sqrt(1 + j), sqrt(j))."""
    def logp(v):
        return -0.5 * v[0] ** 2

    lap = laplace_approximation(logp, torch.zeros(2, dtype=F64))
    assert bool(torch.isnan(lap.chol_precision).all())
    lap_j = laplace_approximation(logp, torch.zeros(2, dtype=F64), jitter=1e-6)
    np.testing.assert_allclose(lap_j.chol_precision.numpy(),
                               np.diag([np.sqrt(1 + 1e-6), 1e-3]), **TOL)


def test_map_laplace_mixed_support():
    """A positive scale and a simplex: the optimiser and the Hessian run
    through the real links; the gradient is ~0 at the optimum, the factor
    and the evidence finite (the iterates on such links: the L-BFGS test's
    model against optax; the Hessian: the batched Hessian tests)."""
    _, tm = _mixed_models()
    res, lap = map_laplace(tm, n_steps=60)
    assert float(res.grad_norm) < 1e-4
    assert bool(torch.isfinite(lap.chol_precision).all())
    assert np.isfinite(float(lap.log_evidence()))


# ---------------------------------------------------------------------------
# the batched Hessian: every link Function twice differentiable
# ---------------------------------------------------------------------------


_S3 = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, -0.2], [0.1, -0.2, 1.0]])
_A3 = np.array([1.0, 2.0, 3.0])


def _hessian_models(family, with_lik):
    wish = (jd.Wishart if family == "wishart" else jd.InverseWishart)(6.5, jnp.asarray(_S3))
    jp = jd.NamedProduct.of(a=jd.Dirichlet(jnp.array([2.0, 3.0, 4.0])), c=jd.LKJ(3, 2.0),
                            W=wish, s=jd.LogNormal(0.0, 0.5))
    jl = tl = None
    if with_lik:
        ja, ta = jnp.asarray(_A3), torch.as_tensor(_A3)

        def jl(x):
            return (jnp.sum(jnp.log(x["a"]) * ja) + 0.3 * jnp.sum(x["c"])
                    - 0.1 * jnp.sum(x["W"] ** 2) + jnp.log(x["s"]))

        def tl(x):
            return (torch.sum(torch.log(x["a"]) * ta) + 0.3 * torch.sum(x["c"])
                    - 0.1 * torch.sum(x["W"] ** 2) + torch.log(x["s"]))

    return (JModel(priors=jp, loglik=jl),
            tbt.Model(tbt.dist_from_spec(spec_of(jp), **CPU64), loglik=tl, device="cpu"))


@pytest.mark.parametrize("family,with_lik", [("wishart", True), ("invwishart", False)])
def test_batched_hessian_matches_jax(family, with_lik):
    """One double-backward pass through the batch-major density against
    jax.hessian, 1e-9. Every link Function of the batch-major path is
    differentiated twice: with a likelihood the simplex and LKJ inverse
    links with x and W, the PD inverse and the PD log density with its
    trace gradient in the dot mode; prior-only the LKJ log-det, the
    simplex log-det without x and the PD log density in the solve mode."""
    jm, tm = _hessian_models(family, with_lik)
    v = 0.4 * np.random.default_rng(0).standard_normal(tm.dim())
    ref = np.asarray(jax.jit(jax.hessian(jm.logdensity_fn()))(jnp.asarray(v)))
    got = hessian(tm.logdensity_fn(), torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


def test_second_derivative_of_fused_density_raises():
    """The fused transposed density's backward has no derivative of its own:
    a second derivative raises rather than returning a partial Hessian."""
    tm = tbt.Model(tbt.dist_from_spec(spec_of(_small_model()), **CPU64), device="cpu")
    vT = (0.3 * torch.randn(tm.dim(), 5, dtype=F64)).requires_grad_(True)
    lp = tm.batched_logdensity_t_fn()(vT)
    (g,) = torch.autograd.grad(lp.sum(), vT, create_graph=True)
    with pytest.raises((RuntimeError, NotImplementedError)):
        torch.autograd.grad(g.sum(), vT)


# ---------------------------------------------------------------------------
# Model.sample(init='laplace')
# ---------------------------------------------------------------------------


def test_sample_init_laplace():
    """The starts are the Laplace Gaussian's draws from the generator and
    inv_mass0 its marginal variances (its covariance for the dense
    metric); a user's inv_mass0 wins; the sampler runs from them."""
    tm = tbt.Model(tbt.dist_from_spec(spec_of(jd.NamedProduct.of(
        mu=jd.Normal(0.5, 1.0), sigma=jd.LogNormal(0.0, 0.5))), **CPU64), device="cpu")
    _, lap = map_laplace(tm)
    want = {"diag": lap.marginal_sd() ** 2, "dense": lap.covariance()}
    for metric in want:
        kw = {"metric": metric}
        q0 = tm._init(torch.Generator().manual_seed(4), 6, "laplace", kw)
        ref = lap.sample(torch.Generator().manual_seed(4), 6)
        np.testing.assert_allclose(q0.numpy(), ref.numpy(), **TOL)
        np.testing.assert_allclose(kw["inv_mass0"].numpy(), want[metric].numpy(), **TOL)
    mine = {"inv_mass0": torch.ones(tm.dim(), dtype=F64)}
    tm._init(torch.Generator().manual_seed(4), 6, "laplace", mine)
    assert torch.equal(mine["inv_mass0"], torch.ones(tm.dim(), dtype=F64))
    raw, _, _ = tm.sample(torch.Generator().manual_seed(1), n_chains=4, n_warmup=10,
                          n_samples=5, kernel="nuts_batched", constrained=False,
                          init="laplace", metric="dense", max_depth=3)
    assert raw.shape == (5, 4, tm.dim()) and bool(torch.isfinite(raw).all())
    with pytest.raises(ValueError, match="unknown init"):
        tm.sample(torch.Generator(), init="prior")
