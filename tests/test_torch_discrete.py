"""The discrete families of the port against the JAX package, float64 on
the CPU.

Poisson, Bernoulli, Binomial, Geometric and Categorical
(`dists/univariate.py`), NegativeBinomial (`univariate2.py`), the nine
of `dists/discrete.py` and Multinomial, with the JAX test matrix's
parameters (`tests/test_all_matrix.py::_discretes`): the pmf's log on a
grid of the support and beyond it (the same -inf pattern, 1e-10 where
finite), the cdf where the JAX family has one, the pmf's gradient in each
tensor leaf against `jax.grad` (1e-9); the registry's Identity link and
the linked density through `unconstrain` (and, for the six the fused plan
serves, its tape's value and gradient); 4000 draws from a
torch.Generator, on the support, their mean within 5 standard errors of
the pmf's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CPU64
from test_torch_remaining_families import (
    close,
    jax_density_and_grads,
    jax_leaves,
    jit,
    port_grads,
    spec,
)

from tpu_bijectors import dists as jd
from tpu_bijectors.registry import bijector as jbijector
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.bijectors.base import Identity
from tpu_bijectors_torch.vectorize import fused_plan as fp
from tpu_bijectors_torch.vectorize import fused_traced as ft

e = jnp.asarray
VAL = dict(rtol=1e-10, atol=1e-10)
DER = dict(rtol=1e-9, atol=1e-9)

# (the JAX family, a grid of its support and beyond)
DISCRETE = {
    "Poisson": (lambda: jd.Poisson(3.0), np.arange(-1.0, 16.0)),
    "Bernoulli": (lambda: jd.Bernoulli(0.3), np.array([0.0, 1.0])),
    "Binomial": (lambda: jd.Binomial(5, 0.4), np.arange(0.0, 6.0)),
    "Geometric": (lambda: jd.Geometric(0.3), np.arange(0.0, 30.0)),
    "Categorical": (lambda: jd.Categorical(jnp.log(e([0.2, 0.5, 0.3]))), np.arange(0.0, 3.0)),
    "NegativeBinomial": (lambda: jd.NegativeBinomial(5.0, 0.5), np.arange(0.0, 30.0)),
    "BernoulliLogit": (lambda: jd.BernoulliLogit(0.4), np.array([0.0, 1.0])),
    "BetaBinomial": (lambda: jd.BetaBinomial(5, 2.0, 2.0), np.arange(-1.0, 7.0)),
    "Dirac": (lambda: jd.Dirac(2.5), np.array([2.5, 1.0, 3.0])),
    "DiscreteUniform": (lambda: jd.DiscreteUniform(1, 10), np.arange(0.0, 12.0)),
    "DiscreteNonParametric": (lambda: jd.DiscreteNonParametric(e([1.0, 3.0, 5.0]),
                                                               e([0.2, 0.5, 0.3])),
                              np.array([1.0, 3.0, 5.0, 2.0])),
    "Hypergeometric": (lambda: jd.Hypergeometric(20, 7, 12), np.arange(5.0, 13.0)),
    "PoissonBinomial": (lambda: jd.PoissonBinomial(e([0.2, 0.5, 0.3])), np.arange(-1.0, 5.0)),
    "Skellam": (lambda: jd.Skellam(2.0, 3.0), np.arange(-15.0, 12.0)),
    "Soliton": (lambda: jd.Soliton(100, 60, 0.2), np.arange(0.0, 102.0)),
    "Multinomial": (lambda: jd.Multinomial(10, e([0.2, 0.5, 0.3])),
                    np.array([[2.0, 5.0, 3.0], [0.0, 10.0, 0.0], [1.0, 1.0, 8.0],
                              [4.0, 4.0, 2.0], [1.0, 1.0, 1.0]])),
}
# the families with a cdf in the JAX package
CDF = ("Poisson", "Bernoulli", "Binomial", "Geometric", "Categorical", "NegativeBinomial",
       "BernoulliLogit", "BetaBinomial", "Dirac", "DiscreteUniform", "DiscreteNonParametric")


def _port(jdist):
    return tbt.dist_from_spec(spec(jdist), **CPU64)


def _pointwise(name, fn):
    """fn(dist, x) over a grid: the JAX Categorical's logpdf and cdf take
    one category at a time (a vmap)."""
    if name == "Categorical":
        return lambda d, z: jax.vmap(lambda zz: fn(d, zz))(z)
    return fn


@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_pmf_cdf_and_gradients(name):
    """The pmf's log on the grid (its -inf pattern beyond the support), the
    cdf, and the gradient of the finite terms in each tensor leaf."""
    make, grid = DISCRETE[name]
    jdist = make()
    tdist = _port(jdist)
    logpdf = _pointwise(name, lambda d, z: d.logpdf(z))
    lp = tdist.logpdf(torch.as_tensor(grid))
    jlp = np.asarray(jit(lambda z: logpdf(jdist, z), e(grid)))
    assert np.array_equal(np.isfinite(lp.numpy()), np.isfinite(jlp))
    fin = np.isfinite(jlp)
    close(lp[torch.as_tensor(fin)], jlp[fin], VAL)
    if name in CDF:
        cdf = _pointwise(name, lambda d, z: d.cdf(z))
        close(tdist.cdf(torch.as_tensor(grid)), jit(lambda z: cdf(jdist, z), e(grid)), VAL)
    leaves = jax_leaves(jdist, tdist)
    if not leaves or name == "Dirac":
        return
    xs = grid[fin]
    _, _, gl = port_grads(tdist, lambda d, z: d.logpdf(z), xs)
    _, (_, jgl) = jit(lambda z, vals: jax_density_and_grads(jdist, z, vals, logpdf), e(xs), leaves)
    for path, g in gl.items():
        close(g, jgl[path], DER)


@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_identity_link_and_linked_density(name):
    """The registry's Identity link (an elementwise Block of it for the
    vector event), the linked length and the linked density, as the JAX
    package's."""
    make, grid = DISCRETE[name]
    jdist = make()
    tdist = _port(jdist)
    b = tbt.bijector(tdist)
    assert type(b).__name__ == type(jbijector(jdist)).__name__
    inner = getattr(b, "bijector", b)
    assert isinstance(inner, Identity)
    uj, ut = junconstrain(jdist), tbt.unconstrain(tdist, device="cpu")
    assert ut.linked_vec_length == uj.linked_vec_length
    x = grid if grid.ndim == 2 else grid[:, None]
    jll = np.asarray(jit(_pointwise(name, lambda u, z: u.linked_logdensity(z)), uj, e(x))
                     if name != "Categorical" else jit(jax.vmap(uj.linked_logdensity), e(x)))
    fin = np.isfinite(jll)
    close(ut.linked_logdensity(torch.as_tensor(x))[torch.as_tensor(fin)], jll[fin], VAL)
    # the served ones (the JAX package's plan serves six: the decision in
    # test_torch_plan_decisions): the tape's value and its gradient in the
    # state at the support's points, against the JAX composed density
    plan = fp._plan(ut)
    if plan is not None:
        xs = x[fin]
        def ref(w):
            out, pull = jax.vjp(uj.linked_logdensity, w)
            return out, pull(jnp.ones_like(out))[0]

        _, jg = jit(ref, e(xs))
        tape = plan[0].tape
        val, par = ft.traced_val_par(tape, tape.params(torch.float64),
                                     torch.as_tensor(xs.T.copy()), True, True)
        close(val, jll[fin], VAL)
        close(par, np.asarray(jg).T, VAL)


@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_draws_on_the_support_with_the_pmfs_mean(name):
    """4000 draws from a torch.Generator: the event's shape, every draw of
    positive mass, the mean within 5 standard errors of the pmf's (its
    grid holds all but a negligible tail)."""
    make, grid = DISCRETE[name]
    jdist = make()
    tdist = _port(jdist)
    x = tdist.sample(torch.Generator().manual_seed(5), (4000,))
    assert x.shape == (4000,) + tuple(tdist.event_shape)
    assert bool(torch.all(torch.isfinite(tdist.logpdf(x))))
    if name == "Multinomial":
        p = np.asarray(jdist.p)
        mean, var = jdist.n * p, jdist.n * p * (1.0 - p)
    else:
        # the unbounded counts' grid extended past their tails
        wide = np.arange(grid.min(), grid.max() + 40.0) if name in (
            "Poisson", "Geometric", "NegativeBinomial", "Skellam") else grid
        pmf = np.exp(np.asarray(jit(_pointwise(name, lambda d, z: d.logpdf(z)), jdist, e(wide))))
        mean = np.sum(wide * pmf)
        var = np.sum((wide - mean) ** 2 * pmf)
    got = x.double().mean(0).numpy()
    assert np.all(np.abs(got - mean) <= 5.0 * np.sqrt(var / 4000) + 1e-12), (got, mean)
