"""The families the traced entries serve, their special functions and the
opcode table of the traced entries' tape, against the JAX package.

Float64 on the CPU: each new family's logpdf, cdf, link and linked
density; the port's regularized incomplete beta against
`jax.scipy.special.betainc`; the ordered bijector; the admission of
every leaf against the JAX package's `_plan` (served, or declined with
the leaf named); each opcode's value and tangent rule against
torch.autograd at its edge points (the CPU half of the #14 probe, whose
card half is `tpu_bijectors_torch/kernels/prim_probe.py`); the opcode
table against the interpreter's enum (kernels/csrc/traced_tape.cuh) and
against the JAX package's admission set; `dist_from_spec` round trips.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy import special as jsp
from test_torch_families import VAL, _close, _port
from test_torch_fused import CPU64, spec_of

from tpu_bijectors import dists as jd
from tpu_bijectors.bijectors.ordered import OrderedBijector as JOrdered
from tpu_bijectors.registry import bijector as jbijector
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import fused_traced as jft
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch.bijectors import OrderedBijector
from tpu_bijectors_torch.dists._special import betainc
from tpu_bijectors_torch.kernels import prim_probe as pp
from tpu_bijectors_torch.vectorize import fused_decomp as fd
from tpu_bijectors_torch.vectorize import fused_plan as fp
from tpu_bijectors_torch.vectorize import fused_traced as ft

ROOT = Path(__file__).resolve().parents[1]
e = jnp.asarray

# every new family and wrapper, with the generic-traced model's parameters
# and the truncated bases the JAX tests use
FAMILIES = {
    "kumaraswamy": lambda: jd.Kumaraswamy(2.0, 3.0),
    "arcsine": lambda: jd.Arcsine(-0.5, 1.5),
    "skewnormal": lambda: jd.SkewNormal(0.1, 1.3, 2.0),
    "betaprime": lambda: jd.BetaPrime(2.0, 3.5),
    "inversegaussian": lambda: jd.InverseGaussian(1.2, 2.0),
    "triangular": lambda: jd.TriangularDist(-1.0, 2.0, 0.5),
    "johnsonsu": lambda: jd.JohnsonSU(0.1, 1.2, 0.3, 1.1),
    "mixture": lambda: jd.Mixture(jd.Normal(e([-2.0, 3.0]), e([1.0, 2.0])),
                                  jnp.log(e([0.5, 0.5]))),
    "trunc_normal": lambda: jd.Truncated(jd.Normal(0.3, 1.2), lower=-0.5, upper=2.0),
    "trunc_studentt": lambda: jd.Truncated(jd.StudentT(4.0, 0.2, 1.1), lower=0.0),
    "trunc_cauchy": lambda: jd.Truncated(jd.Cauchy(0.0, 1.0), lower=0.4),
    "trunc_gumbel": lambda: jd.Truncated(jd.Gumbel(0.1, 0.9), upper=1.5),
    "trunc_logistic": lambda: jd.Truncated(jd.Logistic(0.0, 0.7), lower=-1.0, upper=1.0),
    "trunc_lognormal": lambda: jd.Truncated(jd.LogNormal(0.2, 0.6), upper=3.0),
}
# the families whose support the samples below must stay inside
_SUPPORT = {
    "kumaraswamy": (0.0, 1.0), "arcsine": (-0.5, 1.5), "betaprime": (0.0, None),
    "inversegaussian": (0.0, None), "triangular": (-1.0, 2.0), "trunc_normal": (-0.5, 2.0),
    "trunc_studentt": (0.0, None), "trunc_cauchy": (0.4, None), "trunc_gumbel": (None, 1.5),
    "trunc_logistic": (-1.0, 1.0), "trunc_lognormal": (0.0, 3.0),
}


def _points(name, rng, n=40):
    lo, hi = _SUPPORT.get(name, (None, None))
    if lo is not None and hi is not None:
        return lo + (hi - lo) * rng.uniform(0.02, 0.98, n)
    if lo is not None:
        return lo + np.exp(rng.normal(0.0, 1.0, n))
    if hi is not None:
        return hi - np.exp(rng.normal(0.0, 1.0, n))
    return 2.0 * rng.standard_normal(n)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_logpdf_cdf_link_and_linked_density(name):
    """logpdf and cdf at points of the support, the registry link's both
    directions and log-det, and the linked density, at 1e-12."""
    jdist = FAMILIES[name]()
    tdist = _port(jdist)
    rng = np.random.default_rng(3)
    x = _points(name, rng)
    _close(tdist.logpdf(torch.as_tensor(x)), jdist.logpdf(e(x)), VAL)
    if hasattr(jdist, "cdf") and name != "skewnormal":
        _close(tdist.cdf(torch.as_tensor(x)), jdist.cdf(e(x)), VAL)
    jb, tb = jbijector(jdist), tbt.bijector(tdist)
    y, ld = tb.forward_and_log_det(torch.as_tensor(x))
    jy, jld = jb.forward_and_log_det(e(x))
    _close(y, jy, VAL)
    _close(ld, jld, VAL)
    v = rng.standard_normal(40)
    xx, ild = tb.inverse_and_log_det(torch.as_tensor(v))
    jxx, jild = jb.inverse_and_log_det(e(v))
    _close(xx, jxx, VAL)
    _close(ild, jild, VAL)
    u_j = junconstrain(jdist)
    u_t = tbt.unconstrain(tdist, device="cpu")
    _close(u_t.linked_logdensity(torch.as_tensor(v[:, None])),
           u_j.linked_logdensity(e(v[:, None])), VAL)


@pytest.mark.parametrize("base", ["normal", "studentt", "cauchy", "gumbel", "logistic",
                                  "lognormal"])
def test_the_truncated_bases_cdf(base):
    """The cdf of every base the traced tests truncate, at 1e-12."""
    jdist = {"normal": jd.Normal(0.3, 1.2), "studentt": jd.StudentT(4.0, 0.2, 1.1),
             "cauchy": jd.Cauchy(0.0, 1.0), "gumbel": jd.Gumbel(0.1, 0.9),
             "logistic": jd.Logistic(0.0, 0.7), "lognormal": jd.LogNormal(0.2, 0.6)}[base]
    x = np.linspace(-6.0, 6.0, 97)
    if base == "lognormal":
        x = np.exp(x / 2)
    _close(_port(jdist).cdf(torch.as_tensor(x)), jdist.cdf(e(x)), VAL)


def test_betainc_matches_jax_over_a_grid():
    """The continued fraction against jax.scipy.special.betainc at 1e-12,
    a and b from 0.2 to 50, x over (0, 1) and its ends."""
    rng = np.random.default_rng(5)
    a = np.exp(rng.uniform(np.log(0.2), np.log(50.0), 3000))
    b = np.exp(rng.uniform(np.log(0.2), np.log(50.0), 3000))
    x = rng.uniform(0.0, 1.0, 3000)
    x[:6] = [0.0, 1.0, 1e-12, 1.0 - 1e-12, 0.5, 0.999]
    got = betainc(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(x))
    _close(got, jsp.betainc(a, b, x), dict(rtol=0, atol=1e-12))
    # its derivative in x is the beta density
    xx = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(betainc(torch.tensor(2.0, dtype=torch.float64),
                                       torch.tensor(0.5, dtype=torch.float64), xx), xx)
    _close(g, jax.grad(lambda z: jsp.betainc(2.0, 0.5, z))(0.3), VAL)


def test_ordered_bijector_round_trip_and_log_det():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((9, 5))
    tb, jb = OrderedBijector(), JOrdered()
    x, ld = tb.forward_and_log_det(torch.as_tensor(y))
    jx, jld = jb.forward_and_log_det(e(y))
    _close(x, jx, VAL)
    _close(ld, jld, VAL)
    assert bool(torch.all(x[:, 1:] > x[:, :-1]))
    y2, ild = tb.inverse_and_log_det(x)
    _close(y2, y, dict(rtol=1e-12, atol=1e-12))
    _close(ild, -ld, VAL)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

ADMIT = ("kumaraswamy", "arcsine", "betaprime", "inversegaussian", "triangular",
         "johnsonsu", "mixture", "trunc_normal", "trunc_studentt", "trunc_lognormal")
DECLINE = {
    "skewnormal": lambda: jd.SkewNormal(0.1, 1.3, 2.0),
    "trunc_skewnormal": lambda: jd.Truncated(jd.SkewNormal(0.1, 1.3, 2.0), lower=0.0),
    # a per-element parameter: the traced density is (2,), not a scalar
    "arraydist_kumaraswamy": lambda: jd.arraydist(jd.Kumaraswamy(e([2.0, 3.0]),
                                                                 e([3.0, 4.0]))),
    # 20 mixture weights: a residual over 16 floats
    "mixture_20": lambda: jd.Mixture(jd.Normal(e(np.linspace(-3, 3, 20)), e(np.ones(20))),
                                     e(np.zeros(20))),
}


def _model(leaf):
    return jd.NamedProduct.of(a=jd.Normal(0.0, 1.0), x=leaf)


@pytest.mark.parametrize("name", ADMIT)
def test_admission_parity_served(name):
    """Served in both packages: the port's plan gives the leaf a traced
    entry where the JAX package's has one."""
    d = _model(FAMILIES[name]())
    assert jfk._plan(junconstrain(d), 1e-7) is not None
    plan, why = fp._plan_with_reason(tbt.unconstrain(_port(d), device="cpu"))
    assert why is None
    assert [e_.loop for e_ in plan] == [None, "traced"]


@pytest.mark.parametrize("name", sorted(DECLINE))
def test_admission_parity_declined(name):
    """Declined in both packages; the port names the leaf and why."""
    d = _model(DECLINE[name]())
    assert jfk._plan(junconstrain(d), 1e-7) is None
    plan, why = fp._plan_with_reason(tbt.unconstrain(_port(d), device="cpu"))
    assert plan is None
    leaf = type(DECLINE[name]()).__name__
    leaf = "Kumaraswamy" if leaf == "ElementwiseProduct" else leaf
    assert leaf in why and "traced" in why


def test_a_density_through_a_custom_autograd_rule_declines():
    """A trace keeps an autograd.Function's forward and loses its rule: a
    Dirichlet with a batched alpha (its simplex link's Function) declines,
    naming the rule, and the Function works again after the attempt."""
    d = td.NamedProduct.of(w=td.Dirichlet(np.ones((2, 4)) * 1.5, **CPU64))
    u = tbt.unconstrain(d, device="cpu")
    plan, why = fp._plan_with_reason(u)
    assert plan is None and "custom autograd rule" in why
    # the rule is back: the link's Function runs outside the trace
    u1 = tbt.unconstrain(td.Dirichlet(np.ones(4) * 1.5, **CPU64), device="cpu")
    assert torch.isfinite(u1.linked_logdensity(torch.zeros((3, 3), dtype=torch.float64))).all()


def test_plan_is_memoised_and_tapes_are_small():
    """One trace a leaf per unconstrainer; every tape within the kernel's
    slot cap and JAX's budgets, its liveness allocation below one slot an
    instruction."""
    d = _model(FAMILIES["mixture"]())
    u = tbt.unconstrain(_port(d), device="cpu")
    p1, p2 = fp._plan(u), fp._plan(u)
    assert p1 is p2
    for name in ADMIT:
        u = tbt.unconstrain(_port(_model(FAMILIES[name]())), device="cpu")
        tape = fp._plan(u)[1].tape
        assert tape.n_slots <= fd.MAX_SLOTS and tape.value_ops <= fd.VALUE_BUDGET
        assert tape.deriv_ops <= fd.DERIV_BUDGET
        assert tape.n_slots < tape.n_ins


# ---------------------------------------------------------------------------
# the opcode table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(fd._SAFE_PRIMS, key=lambda n: fd.OPS[n].code))
def test_opcode_rule_against_autograd_at_edge_points(name):
    """Each opcode's value and tangent rule (the plain version of its
    one-op tape) against the torch op and torch.autograd in float64 over
    the probe's grid of edge points: the same NaN/inf pattern, 1e-12."""
    x, y, z = pp.inputs(name, "cpu", B=4096, dtype=torch.float64)
    row = pp.check_op(name, x, y, z)
    assert row["pattern"]
    assert max(row["err_value"], row["err_tangent"]) <= 1e-12


def test_safe_prims_match_the_interpreter_and_the_jax_admission_set():
    """The port's admission set is the interpreter's Opcode enum and the
    plain evaluator's table, number for number; its JAX names are JAX's
    admitted primitives."""
    src = (ROOT / "tpu_bijectors_torch/kernels/csrc/traced_tape.cuh").read_text()
    body = re.search(r"enum Opcode \{(.*?)\};", src, re.S).group(1)
    enum = {re.sub(r"(?<!^)(?=[A-Z])", "_", k).lower(): int(v)
            for k, v in re.findall(r"k(\w+) = (\d+)", body)}
    assert enum == {n: op.code for n, op in fd.OPS.items()}
    assert set(enum) == set(fd._SAFE_PRIMS)
    assert set(fd._OPS.values()) <= fd._SAFE_PRIMS
    jax_names = set().union(*fd.JAX_NAMES.values())
    assert jax_names <= set(jft._SAFE_PRIMS)
    for bad in ("erf", "lgamma", "atan", "digamma"):
        assert bad not in jax_names


def test_tape_plain_matches_the_leaf_density_and_its_autograd():
    """The plain tape of a scalar and a vector leaf against the leaf's own
    linked density and torch.autograd of it."""
    rng = np.random.default_rng(11)
    for leaf in (FAMILIES["trunc_studentt"](), jd.JointOrderStatistics(jd.Gamma(2.0, 1.0), 3)):
        u = tbt.unconstrain(_port(_model(leaf)), device="cpu")
        entry = fp._plan(u)[1]
        L = entry.rows
        V = torch.as_tensor(0.7 * rng.standard_normal((L, 13)))
        val, par = ft.traced_val_par(entry.tape, entry.tape.params(torch.float64), V, True, True)
        w = V.T.clone().requires_grad_(True)
        ref = u.children[1].linked_logdensity(w)
        (g,) = torch.autograd.grad(ref.sum(), w)
        _close(val, ref.detach(), dict(rtol=1e-12, atol=1e-12))
        _close(par, g.T, dict(rtol=1e-10, atol=1e-10))


# ---------------------------------------------------------------------------
# dist_from_spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FAMILIES) + ["jos_normal", "jos_gamma", "iid_trunc"])
def test_dist_from_spec_round_trip(name):
    """spec_of(JAX distribution) -> the port's: the same logpdf; the spec
    of the port's parameters rebuilds the same distribution."""
    jdist = {"jos_normal": lambda: jd.JointOrderStatistics(jd.Normal(0.2, 1.3), 4),
             "jos_gamma": lambda: jd.JointOrderStatistics(jd.Gamma(2.0, 1.0), 3),
             "iid_trunc": lambda: jd.IIDProduct(FAMILIES["trunc_logistic"](), 3),
             }.get(name, FAMILIES.get(name))()
    spec = spec_of(jdist)
    tdist = tbt.dist_from_spec(spec, **CPU64)
    again = tbt.dist_from_spec(spec, **CPU64)
    rng = np.random.default_rng(13)
    if name.startswith("jos"):
        x = np.sort(np.exp(rng.standard_normal((6, jdist.n))), axis=-1)
    elif name == "iid_trunc":
        x = rng.uniform(-0.9, 0.9, (6, 3))
    else:
        x = _points(name, rng, 6)
    _close(tdist.logpdf(torch.as_tensor(x)), jdist.logpdf(e(x)), VAL)
    _close(again.logpdf(torch.as_tensor(x)), tdist.logpdf(torch.as_tensor(x)), VAL)
