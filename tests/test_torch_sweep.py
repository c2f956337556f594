"""The port's property sweep (`tpu_bijectors_torch.testing.test_all`).

It runs in float64 on the CPU on every family that the JAX package's
tests sweep (`tests/test_all_matrix.py`) and that the port has ported,
with the JAX package's parameters (`dist_from_spec`) and arguments. The
port's copy of the Jacobian oracles is held to the JAX package's on the
same arrays, and the sweep must catch a planted fault: a bijector whose
forward log-det has the wrong sign.
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CPU64
from test_torch_vectorize_api import port_spec

import tpu_bijectors as tb
from tpu_bijectors import dists as jd
from tpu_bijectors.testing import oracles as joracles

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.bijectors.base import Bijector
from tpu_bijectors_torch.testing import oracles as toracles
from tpu_bijectors_torch.testing import test_all

e = jnp.asarray

# tests/test_all_matrix.py's rows that the port has: the univariate,
# multivariate, matrix, product and wrapped lists, with their arguments
# (not Truncated(Beta): the port's Beta has no cdf yet, Queue 1 item 5)
SWEPT = {
    "Arcsine": lambda: jd.Arcsine(0.0, 1.0),
    "Beta": lambda: jd.Beta(2.0, 2.0),
    "BetaPrime": lambda: jd.BetaPrime(1.0, 2.0),
    "Cauchy": lambda: jd.Cauchy(-2.0, 1.0),
    "Chi": lambda: jd.Chi(1.0),
    "Exponential": lambda: jd.Exponential(2.0),
    "Frechet": lambda: jd.Frechet(1.0, 1.0),
    "Gamma": lambda: jd.Gamma(7.5, 1.0),
    "Gumbel": lambda: jd.Gumbel(0.0, 1.0),
    "InverseGamma": lambda: jd.InverseGamma(3.0, 0.5),
    "InverseGaussian": lambda: jd.InverseGaussian(1.0, 1.0),
    "JohnsonSU": lambda: jd.JohnsonSU(0.0, 1.0, 0.0, 1.0),
    "Kumaraswamy": lambda: jd.Kumaraswamy(2.0, 5.0),
    "Laplace": lambda: jd.Laplace(0.0, 4.0),
    "Levy": lambda: jd.Levy(0.0, 1.0),
    "Logistic": lambda: jd.Logistic(2.0, 1.0),
    "LogitNormal": lambda: jd.LogitNormal(0.0, 1.0),
    "LogNormal": lambda: jd.LogNormal(0.0, 1.0),
    "Normal": lambda: jd.Normal(0.0, 1.0),
    "Pareto": lambda: jd.Pareto(1.0, 1.0),
    "Rayleigh": lambda: jd.Rayleigh(0.5),
    "SkewNormal": lambda: jd.SkewNormal(0.0, 1.0, -1.0),
    "StudentT": lambda: jd.StudentT(5.0, 0.0, 1.0),
    "TriangularDist": lambda: jd.TriangularDist(0.0, 1.5, 0.5),
    "Uniform": lambda: jd.Uniform(0.0, 1.0),
    "Weibull": lambda: jd.Weibull(0.5, 1.0),
    "Truncated_lower": lambda: jd.Truncated(jd.Normal(), lower=0.0),
    "Truncated_upper": lambda: jd.Truncated(jd.Normal(), upper=0.0),
    "Truncated_both": lambda: jd.Truncated(jd.Normal(), lower=0.0, upper=1.0),
    "Mixture_3": lambda: jd.Mixture(jd.Normal(e([-2.0, 0.0, 3.0]), e([1.2, 1.0, 2.5])),
                                    jnp.log(e([0.2, 0.5, 0.3]))),
    "Mixture_1": lambda: jd.Mixture(jd.Normal(e([0.0]), e([1.0])), jnp.log(e([1.0]))),
    "Mixture_Beta": lambda: jd.Mixture(jd.Beta(e([2.0, 5.0]), e([2.0, 1.0])), jnp.log(e([0.5, 0.5]))),
    "Dirichlet": lambda: jd.Dirichlet(e([2.0, 3.0, 4.0])),
    "MvNormalDiag": lambda: jd.MvNormalDiag(jnp.zeros(4), jnp.ones(4)),
    "MvNormalTril": lambda: jd.MvNormalTril(e([0.5, -1.0]), e([[2.0, 0.0], [0.3, 1.5]])),
    "MvLogNormal": lambda: jd.MvLogNormal(jnp.zeros(3), jnp.ones(3)),
    "MvStudentT": lambda: jd.MvStudentT(4.0, jnp.zeros(3), jnp.eye(3, dtype=jnp.float64)),
    "MvNormalCanon": lambda: jd.MvNormalCanon(
        e([1.0, 2.0, 3.0]), e([[4.0, -2.0, -1.0], [-2.0, 5.0, -1.0], [-1.0, -1.0, 6.0]])),
    "JointOrderStatistics": lambda: jd.JointOrderStatistics(jd.Normal(), 4),
    "LKJ3": lambda: jd.LKJ(3, 2.0),
    "LKJ4": lambda: jd.LKJ(4, 1.0),
    "LKJCholesky_L": lambda: jd.LKJCholesky(3, 1.5, "L"),
    "LKJCholesky_U": lambda: jd.LKJCholesky(3, 1.5, "U"),
    "Wishart": lambda: jd.Wishart(6.0, jnp.eye(3, dtype=jnp.float64)),
    "InverseWishart": lambda: jd.InverseWishart(6.0, jnp.eye(3, dtype=jnp.float64)),
    "IID_Beta": lambda: jd.IIDProduct(jd.Beta(2.0, 2.0), 10),
    "IID_Dirichlet": lambda: jd.IIDProduct(jd.Dirichlet(jnp.ones(3)), 4),
    "arraydist_Normal": lambda: jd.arraydist(jd.Normal(e([-1.0, 0.0, 2.0]), e([0.5, 1.0, 2.0]))),
    "arraydist_LogNormal": lambda: jd.arraydist(jd.LogNormal(e([0.0, 0.3]), e([0.5, 1.2]))),
    "arraydist_Beta": lambda: jd.arraydist(jd.Beta(e([2.0, 5.0, 1.5]), e([2.0, 1.0, 3.0]))),
    "arraydist_Dirichlet": lambda: jd.arraydist(jd.Dirichlet(e([[1.3, 2.0, 0.8], [2.5, 1.0, 1.7]]))),
    "Product": lambda: jd.Product((jd.LogNormal(), jd.Beta(2.0, 2.0), jd.Normal())),
    "NamedProduct": lambda: jd.NamedProduct.of(mu=jd.Normal(), sigma=jd.LogNormal(),
                                               w=jd.Dirichlet(jnp.ones(4))),
    "NamedProduct_nested": lambda: jd.NamedProduct.of(
        a=jd.IIDProduct(jd.Gamma(2.0, 3.0), 5), b=jd.Product((jd.Beta(1.0, 2.0), jd.Normal())),
        c=jd.NamedProduct.of(x=jd.LKJ(3, 1.0), y=jd.Uniform(-1.0, 2.0))),
    "Product_nested": lambda: jd.Product((jd.Product((jd.Normal(), jd.LogNormal())), jd.Beta(2.0, 2.0))),
    "transformed_LogNormal": lambda: tb.transformed(jd.LogNormal()),
    "transformed_Beta": lambda: tb.transformed(jd.Beta(2.0, 2.0)),
    "IID_IID_LogNormal": lambda: jd.IIDProduct(jd.IIDProduct(jd.LogNormal(), 3), 2),
}
# the JAX sweep's heavy-tailed rows, whose random inputs it scales down
SCALE_DOWN = ("Levy", "Frechet")


@pytest.mark.parametrize("name", sorted(SWEPT))
def test_sweep_passes(name):
    d = tbt.dist_from_spec(port_spec(SWEPT[name]()), **CPU64)
    assert test_all(d, inverse_scale=0.5 if name in SCALE_DOWN else 1.0)


@dataclass(frozen=True)
class _WrongSignExp(Bijector):
    """exp with its forward log-det's sign flipped (the planted fault);
    its inverse is right."""

    def forward_and_log_det(self, x):
        return torch.exp(x), -x

    def inverse_and_log_det(self, y):
        return torch.log(y), -torch.log(y)


def test_sweep_catches_a_wrong_log_det_sign():
    d = tbt.transformed(tbt.dists.Normal(0.0, 1.0, **CPU64), _WrongSignExp())
    with pytest.raises(AssertionError):
        test_all(d, skip=("inverse", "trace", "optics", "logjac", "grad", "jacobian", "logpdf"))
    with pytest.raises(AssertionError):
        test_all(d, skip=("roundtrip",))


def test_oracles_match_jax(rng):
    """The port's copy of the hand-derived Jacobians against the JAX
    package's on the same arrays."""
    x = rng.dirichlet(np.ones(5))
    y = rng.standard_normal(4)
    np.testing.assert_array_equal(toracles.simplex_link_jacobian(x), joracles.simplex_link_jacobian(x))
    np.testing.assert_array_equal(toracles.simplex_invlink_jacobian(y),
                                  joracles.simplex_invlink_jacobian(y))
    dx, yo = rng.standard_normal(5), np.sort(rng.standard_normal(5))
    np.testing.assert_array_equal(toracles.ordered_forward_vjp(yo, dx), joracles.ordered_forward_vjp(yo, dx))
    np.testing.assert_array_equal(toracles.ordered_inverse_vjp(yo, dx), joracles.ordered_inverse_vjp(yo, dx))
    yv = 0.5 * rng.standard_normal(6)
    (W, lj), vjp = toracles.lkj_invlink_with_vjp(yv)
    (Wj, ljj), vjpj = joracles.lkj_invlink_with_vjp(yv)
    np.testing.assert_array_equal(W, Wj)
    assert lj == ljj
    dW = rng.standard_normal((4, 4))
    np.testing.assert_array_equal(vjp(dW, 0.7), vjpj(dW, 0.7))
    np.testing.assert_array_equal(toracles.lkj_link_from_upper_vjp(W, yv),
                                  joracles.lkj_link_from_upper_vjp(W, yv))
    # and the oracles against the port's links: J_link J_invlink = I
    xs = tbt.bijectors.SimplexBijector().inverse(torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(
        toracles.simplex_link_jacobian(xs) @ toracles.simplex_invlink_jacobian(y), np.eye(4), atol=1e-10)
