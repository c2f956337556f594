"""The three traced models in all four modes against the JAX package.

`generic-traced` (tools/tpu_sweep.py:92-104: nine traced entries), the
JAX tests' truncated-leaves model (tests/test_transposed_layout.py:
273-283: the three interval branches and an IID block of three truncated
Logistics, beside a slab row) and vector-leaves model (:381-385: two
JointOrderStatistics beside a slab row), each exactly as written, in
float64 on the CPU: the port's plain whole-model functions (the traced
loop kind's plain tape) against the JAX package's mega kernels in
interpret mode at its tests' batches (48, 21, 15), and value and gradient
against torch.autograd of the composed path; chip_smoke.py's copies of
the models against the JAX ones; a short NUTS run on the plain tapes.
On the CPU the wrappers run the plain versions; chip_smoke.py holds the
CUDA kernel's traced kind to them on the card.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _close, _pair, _port

from tpu_bijectors import dists as jd
from tpu_bijectors.vectorize import fused_kernel as jfk

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch.vectorize import fused_base as tfb
from tpu_bijectors_torch.vectorize import fused_kernel as tfk
from tpu_bijectors_torch.vectorize import fused_plan as tfp

ROOT = Path(__file__).resolve().parents[1]
VAL = dict(rtol=1e-10, atol=1e-10)
DER = dict(rtol=1e-9, atol=1e-9)
e = jnp.asarray

MODELS = {
    "generic-traced": lambda: jd.NamedProduct.of(
        tn=jd.Truncated(jd.Normal(0.3, 1.2), lower=-0.5, upper=2.0),
        tst=jd.Truncated(jd.StudentT(4.0, 0.2, 1.1), lower=0.0),
        ku=jd.Kumaraswamy(2.0, 3.0),
        bp=jd.BetaPrime(2.0, 3.5),
        ig=jd.InverseGaussian(1.2, 2.0),
        js=jd.JohnsonSU(0.1, 1.2, 0.3, 1.1),
        tri=jd.TriangularDist(-1.0, 2.0, 0.5),
        mx=jd.Mixture(jd.Normal(e([-2.0, 3.0]), e([1.0, 2.0])), jnp.log(e([0.5, 0.5]))),
        jo=jd.JointOrderStatistics(jd.Normal(0.2, 1.3), 4),
    ),
    "truncated-leaves": lambda: jd.NamedProduct.of(
        tn=jd.Truncated(jd.Normal(0.3, 1.2), lower=-0.5, upper=2.0),
        tlo=jd.Truncated(jd.Cauchy(0.0, 1.0), lower=0.4),
        thi=jd.Truncated(jd.Gumbel(0.1, 0.9), upper=1.5),
        iid=jd.IIDProduct(jd.Truncated(jd.Logistic(0.0, 0.7), lower=-1.0, upper=1.0), 3),
        tln=jd.Truncated(jd.LogNormal(0.2, 0.6), upper=3.0),
        mu=jd.Normal(0.0, 2.0),
    ),
    "vector-leaves": lambda: jd.NamedProduct.of(
        jo=jd.JointOrderStatistics(jd.Normal(0.2, 1.3), 4),
        jg=jd.JointOrderStatistics(jd.Gamma(2.0, 1.0), 3),
        mu=jd.Normal(0.0, 2.0),
    ),
}
# the JAX tests' batch and state scale for each
BATCH = {"generic-traced": (48, 0.6), "truncated-leaves": (21, 0.8), "vector-leaves": (15, 0.6)}
# the plan: (traced entries, slab rows, rows of the traced entries)
PLANS = {"generic-traced": (9, 0, (1, 1, 1, 1, 1, 1, 1, 1, 4)),
         "truncated-leaves": (5, 1, (1, 1, 1, 3, 1)),
         "vector-leaves": (2, 1, (4, 3))}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    name = request.param
    u_j, u_t = _pair(MODELS[name]())
    B, scale = BATCH[name]
    rng = np.random.default_rng(41)
    dim = u_t.linked_vec_length
    vT = np.ascontiguousarray(scale * rng.standard_normal((B, dim)).T)
    dvT = np.ascontiguousarray(rng.standard_normal((B, dim)).T)
    return name, u_j, u_t, vT, dvT, rng.standard_normal(B)


def test_plan_serves_every_traced_leaf(case):
    """Every leaf with no closed form gets a traced entry, the Normal a
    slab row; the JAX package plans as many entries."""
    name, u_j, u_t, vT, _, _ = case
    plan = tfp._plan(u_t)
    traced = [p for p in plan if p.loop == "traced"]
    n_traced, n_slab, rows = PLANS[name]
    assert len(traced) == n_traced and len(plan) == n_traced + n_slab
    assert tuple(p.rows for p in traced) == rows
    assert len(jfk._plan(u_j, 1e-7)) == len(plan)
    _, loops, _ = tfk._prep(u_t, torch.as_tensor(vT))
    assert [c for c, *_ in loops.entries] == [tfb.TRACED] * n_traced
    assert loops.tape.dtype == torch.int32 and len(loops.tapes) == n_traced


def test_traced_model_value_matches_jax(case):
    """The fused value (the plain tapes) against the JAX package's
    mega_logdensity_t in interpret mode and the composed path."""
    _, u_j, u_t, vT, _, _ = case
    lp = u_t.linked_logdensity_t(torch.as_tensor(vT))
    ref = jax.jit(lambda v: jfk.mega_logdensity_t(u_j, v, interpret=True))(jnp.asarray(vT))
    _close(lp, ref, VAL)
    _close(u_t._linked_logdensity_t_children(torch.as_tensor(vT)), ref, VAL)


def test_traced_model_vjp_and_jvp_match_jax(case):
    """autograd's backward (the VJP mode) and torch.func.jvp (the JVP mode)
    against mega_vjp_t and mega_jvp_t in interpret mode."""
    _, u_j, u_t, vT, dvT, ct = case
    vj = jnp.asarray(vT)
    w = torch.as_tensor(vT).requires_grad_(True)
    (g,) = torch.autograd.grad(u_t.linked_logdensity_t(w), w, torch.as_tensor(ct))
    _close(g, jax.jit(lambda v, c: jfk.mega_vjp_t(u_j, v, c, interpret=True))(
        vj, jnp.asarray(ct)), DER)
    _, dlp = torch.func.jvp(u_t.linked_logdensity_t, (torch.as_tensor(vT),),
                            (torch.as_tensor(dvT),))
    _close(dlp, jax.jit(lambda v, d: jfk.mega_jvp_t(u_j, v, d, interpret=True))(
        vj, jnp.asarray(dvT)), DER)


def test_traced_model_value_and_grad_match_autograd_of_the_composed_path(case):
    """The one-pass value and gradient (the plain tapes on dual numbers)
    against torch.autograd of the composed per-leaf path."""
    name, _, u_t, vT, _, _ = case
    model = tbt.Model(_port(MODELS[name]()), device="cpu")
    lp, g = model.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    w = torch.as_tensor(vT).requires_grad_(True)
    comp = u_t._linked_logdensity_t_children(w)
    (gc,) = torch.autograd.grad(comp.sum(), w)
    _close(lp, comp.detach(), VAL)
    _close(g, gc, DER)


def test_chip_smoke_models_are_the_jax_models(case):
    """chip_smoke.py's traced models are the JAX ones: the same dim, loop
    entries, parameter blocks and tapes."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    name, _, u_t, vT, _, _ = case
    u_c = tbt.Model(chip_smoke.TRACED_MODELS[name](td, "cpu", torch.float64),
                    device="cpu").unconstrainer()
    assert u_c.linked_vec_length == u_t.linked_vec_length
    a = tfk._prep(u_t, torch.as_tensor(vT))
    b = tfk._prep(u_c, torch.as_tensor(vT))
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert a[1].entries == b[1].entries and torch.equal(a[1].prm, b[1].prm)
    assert torch.equal(a[1].tape, b[1].tape)
    if name == "generic-traced":
        assert u_c.linked_vec_length == chip_smoke.TRACED_DIM
        assert set(chip_smoke.TRACED_MEANS) == set(u_c.names)


def test_nuts_on_the_traced_model_runs_on_the_plain_tapes():
    """Model.sample(kernel='auto') takes nuts_batched_t on the CPU (the
    plain tapes in every leapfrog): finite draws inside every support."""
    model = tbt.Model(_port(MODELS["generic-traced"]()), device="cpu")
    assert model._auto_kernel() == "nuts_batched_t"
    gen = torch.Generator().manual_seed(0)
    x, _, stats = model.sample(gen, n_chains=4, n_warmup=15, n_samples=6, max_depth=4)
    assert x["tn"].shape == (6, 4) and x["jo"].shape == (6, 4, 4)
    assert bool(((x["tn"] >= -0.5) & (x["tn"] <= 2.0)).all())
    assert bool((x["tst"] >= 0).all() and (x["ku"] > 0).all() and (x["ku"] < 1).all())
    assert bool((x["jo"][..., 1:] >= x["jo"][..., :-1]).all())
    assert bool(torch.isfinite(stats.accept_prob).all())
