"""The fused plan's decisions on the seventeenth slice's families, and the
tape's cos and sin opcodes, against the JAX package (float64, CPU).

For every new family (the continuous ones, the wrappers, the matrix and
vector families and the discrete ones), `NamedProduct.of(a=d, m=Normal(0,
1))` is built in both packages: the port's `_plan` serves it exactly when
the JAX package's `_plan` does, a declined leaf named in the reason.
Where both serve it, the leaf's tape fits the kernel's slots and JAX's
op budgets; its value and gradient (`run_tape_plain` through
`traced_val_par`) are held to the JAX package's composed linked density
and `jax.grad` of it within 1e-10 by
`test_torch_remaining_families.py::test_density_link_and_linked_density`
and `test_torch_discrete.py::test_identity_link_and_linked_density`. The
cos and sin opcodes' value and tangent rules are held to torch's
forward-mode AD at 0, +-pi and +-1e4, in float64 and float32; the leaves
path 27 holds to no NaN at +-1e10 are held to the JAX package's float32
values there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from test_torch_discrete import DISCRETE
from test_torch_remaining_families import FAMILIES, port, spec

from tpu_bijectors import dists as jd
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch.vectorize import fused_decomp as fd
from tpu_bijectors_torch.vectorize import fused_plan as fp
from tpu_bijectors_torch.vectorize import fused_traced as ft

TAPE = dict(rtol=1e-10, atol=1e-10)
ALL = {**FAMILIES, **{k: v[0] for k, v in DISCRETE.items()}}
# the families the JAX package's plan serves (its decision, re-derived by
# the test below; listed so that a change in either package shows)
SERVED = {"Chisq", "FDist", "VonMises", "Semicircle", "Cosine", "Epanechnikov",
          "GeneralizedExtremeValue", "Gompertz", "Erlang", "LogUniform", "NormalCanon",
          "Biweight", "Triweight", "SymTriangularDist", "PGeneralizedGaussian", "Lindley",
          "Kolmogorov", "SkewedExponentialPower", "KSOneSided", "Affine_Gamma", "Affine_Beta",
          "Affine_Logistic", "Censored", "Censored_lower", "Bernoulli", "BernoulliLogit",
          "Dirac", "DiscreteNonParametric", "DiscreteUniform", "Geometric"}


@pytest.mark.parametrize("name", sorted(ALL))
def test_plan_serves_a_family_exactly_where_the_jax_plan_does(name):
    jdist = ALL[name]()
    served = jfk._plan(junconstrain(jd.NamedProduct.of(a=jdist, m=jd.Normal(0.0, 1.0))),
                       1e-7) is not None
    assert served == (name in SERVED)
    tdist = port(jdist)
    model = tbt.dists.NamedProduct.of(a=tdist, m=tbt.dists.Normal(0.0, 1.0, device="cpu",
                                                                  dtype=torch.float64))
    plan, why = fp._plan_with_reason(tbt.unconstrain(model, device="cpu"))
    assert (plan is not None) == served, why
    if plan is None:
        assert type(tdist).__name__ in why
        return
    entry = plan[0]
    assert entry.loop == "traced"
    tape = entry.tape
    assert tape.n_slots <= fd.MAX_SLOTS and tape.value_ops <= fd.VALUE_BUDGET
    assert tape.deriv_ops <= fd.DERIV_BUDGET


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["cos", "sin"])
def test_cos_and_sin_rules_against_forward_mode(name, dtype):
    """The opcode's value and tangent rule against torch's op and its
    forward-mode derivative at 0, +-pi and +-1e4 (and a unit and a random
    tangent), bit for bit; the plain one-op tape agrees."""
    from tpu_bijectors_torch.kernels import prim_probe as pp

    x = torch.tensor([0.0, np.pi, -np.pi, 1e4, -1e4, 0.5, -2.0], dtype=dtype)
    for t in (torch.ones_like(x), torch.linspace(-3.0, 2.0, 7, dtype=dtype)):
        r, tt = fd.apply_op(name, x, None, None, t, None, None)
        with fwAD.dual_level():
            ref, dref = fwAD.unpack_dual(getattr(torch, name)(fwAD.make_dual(x, t)))
        assert torch.equal(r, ref) and torch.equal(tt, dref)
        if bool(torch.all(t == 1.0)):
            pr, pt = pp.prim_probe_plain(name, x, torch.zeros_like(x), torch.zeros_like(x), 0)
            assert torch.equal(pr, ref) and torch.equal(pt, dref)


# path 27's extremes block (chip_smoke.P27_FINITE_AT_EXTREMES and
# P27_NEG_INF_AT_EXTREMES): its leaves, with the served model's parameters
P27_LEAVES = {"vm": "VonMises", "lu": "LogUniform", "nc": "NormalCanon",
              "pgg": "PGeneralizedGaussian", "sep": "SkewedExponentialPower", "cen": "Censored",
              "semi": "Semicircle", "cos": "Cosine", "epa": "Epanechnikov", "bw": "Biweight",
              "tw": "Triweight", "sym": "SymTriangularDist"}


def test_the_card_extremes_leaves_are_nan_free_in_jax():
    """The leaves chip_smoke's path 27 holds to no NaN at v = +-1e10: the
    JAX package's float32 linked density there is finite (or -inf for the
    bounded kernels), and the port's float32 tape gives the same."""
    import chip_smoke as cs

    assert set(P27_LEAVES) == set(cs.P27_FINITE_AT_EXTREMES + cs.P27_NEG_INF_AT_EXTREMES)
    v = np.array([1e10, -1e10], dtype=np.float32)
    with jax.enable_x64(False):  # the card's float32, one compile
        us = {key: junconstrain(FAMILIES[name]()) for key, name in P27_LEAVES.items()}
        jlps = jax.jit(lambda w: {k: u.linked_logdensity(w) for k, u in us.items()})(
            jnp.asarray(v[:, None]))
    for key, name in P27_LEAVES.items():
        jdist = FAMILIES[name]()
        jlp = np.asarray(jlps[key])
        assert jlp.dtype == np.float32
        if key in cs.P27_FINITE_AT_EXTREMES:
            assert np.all(np.isfinite(jlp)), (name, jlp)
        else:
            assert np.all(jlp == -np.inf), (name, jlp)
        td32 = tbt.dist_from_spec(spec(jdist), device="cpu", dtype=torch.float32)
        plan = fp._plan(tbt.unconstrain(tbt.dists.NamedProduct.of(a=td32), device="cpu"))
        tape = plan[0].tape
        val, _ = ft.traced_val_par(tape, tape.params(torch.float32),
                                   torch.as_tensor(v[None]), True, False)
        assert np.array_equal(np.isfinite(val.numpy()), np.isfinite(jlp)), name
        assert not bool(torch.isnan(val).any()), name
