"""The port's ChEES-HMC against the JAX package, float64 on the CPU.

The van der Corput jitter, and the first warmup and sampling transitions
of `run_chees` given the JAX run's own draws (each transition's momentum
normal and accept uniforms from its keys): the trajectory, the ChEES
log-T gradient from the proposed endpoints, the Adam step on log T, the
dual-averaged step and the mass windows, diagonal and dense (1e-12).
Whole runs with the JAX tests' own tolerances (tests/test_chees.py): the
trajectory stretched to the widest scale, the correlated Gaussian's
moments, recovery from divergent early warmup, the dense metric, and the
constrained Beta-Binomial model through `run_chees` and
`Model.sample(kernel='chees')`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bijectors.infer import run_chees as jrun_chees
from tpu_bijectors.infer.chees import _halton2 as j_halton2

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists
from tpu_bijectors_torch.infer import chees, hmc_batched, run_chees
from tpu_bijectors_torch.infer.adapt import build_schedule

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_halton_matches_jax():
    u = np.array([chees._halton2(i) for i in range(256)])
    np.testing.assert_array_equal(u, np.asarray(jax.vmap(j_halton2)(jnp.arange(256))))
    assert np.all((u > 0) & (u < 1))
    # van der Corput base 2: any 2^k-length prefix is perfectly stratified
    for width in (0.5, 0.25, 0.125):
        counts, _ = np.histogram(u[:64], bins=int(1 / width), range=(0, 1))
        assert counts.max() == counts.min()


_PREC = np.array([[2.0, 0.6, 0.1], [0.6, 1.0, -0.3], [0.1, -0.3, 0.8]])


@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_first_transitions_match_jax(rng, metric):
    """Three warmup transitions (the schedule of n_warmup = 3: a mass window
    of one transition that refreshes the metric, between two step-size-only
    ones) and two sampling transitions on the JAX run's draws: every field
    of the state, the draws and the stats."""
    P, jP = torch.as_tensor(_PREC), jnp.asarray(_PREC)

    def logp(v):
        return -0.5 * torch.sum((v @ P) * v, -1)

    def jlogp(v):
        return -0.5 * jnp.sum((v @ jP) * v, -1)

    logp.batch_capable = jlogp.batch_capable = True
    q0 = rng.standard_normal((6, 3))
    key = jax.random.PRNGKey(17)
    # eps0 = 0.25: the first trajectory's u T / eps is 5 exactly, and the
    # initial T = exp(log(10 eps0)) is exact in both packages, so the ceil
    # takes the same side of 5 (with 0.3, XLA's exp gives 3.0, torch's
    # 3.0000000000000004, and the two runs take 5 and 6 leapfrogs)
    kw = dict(n_warmup=3, n_samples=2, eps0=0.25, metric=metric)
    jsamples, jst, jstats = jrun_chees(jlogp, key, jnp.asarray(q0), **kw)

    def draws(k):
        k_step, k_next = jax.random.split(k)
        k_mom, k_acc = jax.random.split(k_step)
        z = np.array(jax.random.normal(k_mom, q0.shape, jnp.float64))
        u = np.array(jax.random.uniform(k_acc, (q0.shape[0],), jnp.float64))
        return k_next, torch.as_tensor(z), torch.as_tensor(u)

    vg = hmc_batched._batched_logp_and_grad(logp)
    dense = metric == "dense"
    st = chees._init_state(vg, torch.Generator(), torch.as_tensor(q0), 0.25, dense)
    wid, wend = build_schedule(3)
    for i in range(3):
        key, z, u = draws(key)
        st, _ = chees._warmup_step(vg, st, int(wid[i]), bool(wend[i]), z, u, dense=dense,
                                   target_accept=0.651, lr_t=0.05, max_steps=1024)
    st = st._replace(eps=torch.exp(st.ss.log_eps_bar))
    samples, stats = [], []
    for _ in range(2):
        key, z, u = draws(key)
        st, (q1, *s) = chees._sample_step(vg, st, z, u, 1024)
        samples.append(q1)
        stats.append(s)
    np.testing.assert_allclose(torch.stack(samples).numpy(), np.asarray(jsamples), **TOL)
    for f in ("q", "logp", "grad", "eps", "log_t", "inv_mass", "adam_m", "adam_v"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(jst, f)), **TOL)
    for a, b in zip(st.ss + st.welford, jst.ss + jst.welford):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **TOL)
    assert st.iteration == int(jst.iteration) == 5
    for got, ref in zip(zip(*stats), jstats):
        np.testing.assert_allclose(torch.stack(got).numpy().astype(np.float64),
                                   np.asarray(ref).astype(np.float64), **TOL)


# ---------------------------------------------------------------------------
# whole runs, in distribution (tests/test_chees.py's tolerances)
# ---------------------------------------------------------------------------


def test_chees_adapts_trajectory_to_widest_scale():
    """N(0, diag(1, 100)): T an order of magnitude beyond the step. The
    adapted T / eps varies widely from run to run in both packages (the
    JAX package's run of this test under keys 0-7 ends below 5 under two
    of them, as the port's does under torch seeds 0 and 1): seed 2."""
    sd = torch.tensor([1.0, 10.0], dtype=F64)

    def logp(v):
        return -0.5 * torch.sum((v / sd) ** 2, -1)

    logp.batch_capable = True
    g = torch.Generator().manual_seed(2)
    q0 = torch.randn((32, 2), generator=g, dtype=F64)
    hmc_batched.reset_sync_count()
    samples, state, stats = run_chees(logp, g, q0, n_warmup=700, n_samples=700)
    # the trajectory length is read to the host once a transition
    assert hmc_batched.SYNCS["trajectory"] == 1400
    assert float(torch.exp(state.log_t)) > 5.0 * float(state.eps)
    x = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(x.mean(0), 0.0, atol=0.35)
    np.testing.assert_allclose(x.std(0), sd.numpy(), rtol=0.12)
    assert float(state.inv_mass[1] / state.inv_mass[0]) > 10.0


def test_chees_correlated_gaussian_moments():
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    P = torch.as_tensor(np.linalg.inv(cov))

    def logp(v):  # per-example, lifted by vmap
        return -0.5 * v @ P @ v

    g = torch.Generator().manual_seed(2)
    q0 = 0.5 * torch.randn((16, 2), generator=g, dtype=F64)
    samples, _, stats = run_chees(logp, g, q0, n_warmup=600, n_samples=1000)
    x = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.12)
    assert 0.4 < float(stats.accept_prob.mean()) < 0.95
    assert stats.n_steps.ndim == 1  # one lockstep trajectory a transition


def test_chees_divergence_does_not_poison_adaptation():
    def logp(v):
        return -0.5 * torch.sum((v / 0.01) ** 2, -1)

    logp.batch_capable = True
    g = torch.Generator().manual_seed(8)
    q0 = torch.randn((8, 2), generator=g, dtype=F64)
    _, st_a, stats_a = run_chees(logp, g, q0, n_warmup=5, n_samples=50, eps0=5.0)
    assert bool(stats_a.diverging.any())
    for leaf in (st_a.log_t, st_a.adam_m, st_a.adam_v):
        assert bool(torch.isfinite(leaf).all())
    samples, st, _ = run_chees(logp, g, q0, n_warmup=400, n_samples=200, eps0=5.0)
    for leaf in (st.log_t, st.eps, st.adam_m, st.adam_v):
        assert bool(torch.isfinite(leaf).all())
    assert float(st.inv_mass.max()) < 1e-2
    x = samples.reshape(-1, 2).numpy()
    assert np.all(np.isfinite(x))
    np.testing.assert_allclose(x.std(0), 0.01, rtol=0.3)


def test_chees_dense_metric():
    cov = np.array([[1.0, 0.95], [0.95, 1.0]])
    P = torch.as_tensor(np.linalg.inv(cov))

    def logp(v):
        return -0.5 * torch.einsum("...i,ij,...j->...", v, P, v)

    logp.batch_capable = True
    g = torch.Generator().manual_seed(6)
    q0 = 0.3 * torch.randn((16, 2), generator=g, dtype=F64)
    samples, state, _ = run_chees(logp, g, q0, n_warmup=600, n_samples=800, metric="dense")
    assert state.inv_mass.shape == (2, 2)
    np.testing.assert_allclose(state.inv_mass.numpy(), cov, atol=0.25)
    np.testing.assert_allclose(np.cov(samples.reshape(-1, 2).numpy().T), cov, atol=0.12)
    with pytest.raises(ValueError, match="metric"):
        run_chees(logp, g, q0, metric="bogus")


def test_chees_constrained_model():
    """Beta-Binomial through the vectorize layer: the conjugate posterior's
    mean from run_chees on the batch-major density and from
    Model.sample(kernel='chees'), which drops a warm-start inv_mass0."""
    m = tbt.Model(
        dists.NamedProduct.of(p=dists.Beta(2.0, 2.0, device="cpu", dtype=F64)),
        loglik=lambda x: 17 * torch.log(x["p"]) + 33 * torch.log1p(-x["p"]),
        device="cpu",
    )
    g = torch.Generator().manual_seed(3)
    q0 = 0.5 * torch.randn((16, 1), generator=g, dtype=F64)
    samples, _, _ = run_chees(m.batched_logdensity_fn(), g, q0, n_warmup=500, n_samples=800)
    p = m.constrain(samples.reshape(-1, 1))["p"].numpy()
    np.testing.assert_allclose(p.mean(), 19.0 / 54.0, atol=0.02)
    s2, state, _ = m.sample(torch.Generator().manual_seed(7), n_chains=16, n_warmup=400,
                            n_samples=600, kernel="chees", inv_mass0=torch.ones(1))
    assert isinstance(state, chees.CheesState)
    np.testing.assert_allclose(float(s2["p"].mean()), 19.0 / 54.0, atol=0.02)
