"""The port's serving export (`tpu_bijectors_torch.serving`) against the
live density and the JAX package's artifacts, float64 on the CPU: the
cases of tests/test_serving.py on its model.

- Round trips by bytes and by path, the value-and-gradient artifact, the
  constrain artifact and the frozen shape and dtype contract, each held
  against the live port and against the JAX package's `serving.export_*`
  / `load` on the same numpy states (1e-12 for values, 1e-10 for
  gradients); the transposed artifacts against the live transposed
  density bit for bit.
- The card route, exported under `FakeTensorMode` on fake `cuda` tensors:
  its graph records the `tbt::` operators of #1 and #2 (both designs) and
  no plain path, and with the kernels disabled the export raises. The
  plan's tables cannot be made under fake mode (the run and item tables
  read cf on the host), so the test makes them on the CPU from the
  float32 plan and hands fake `cuda` tensors of their shapes to the
  model's caches; the batch-major route needs the model's parameters on
  `cuda`, which a CPU-only torch cannot make even as fake tensors, so
  chip_smoke.py path 29 (b) alone checks it.
"""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tpu_bijectors import dists as jdists
from tpu_bijectors import serving as jserving
from tpu_bijectors.infer import Model as JModel

from tpu_bijectors_torch import dists, kernels, serving
from tpu_bijectors_torch.infer import Model
from tpu_bijectors_torch.vectorize import fused_kernel as fk

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)


def _loglik(x):
    return -0.5 * (x["mu"] - 1.0) ** 2 / x["s"] ** 2


@pytest.fixture(scope="module")
def models():
    port = Model(dists.NamedProduct.of(mu=dists.Normal(0.0, 2.0, **KW),
                                       s=dists.LogNormal(0.0, 0.5, **KW),
                                       w=dists.Dirichlet(torch.ones(3, **KW), **KW)),
                 loglik=_loglik, device="cpu")
    ref = JModel(priors=jdists.NamedProduct.of(mu=jdists.Normal(0.0, 2.0),
                                               s=jdists.LogNormal(0.0, 0.5),
                                               w=jdists.Dirichlet(jnp.ones(3))),
                 loglik=_loglik)
    return port, ref


def _state(shape, scale, seed):
    return scale * np.random.default_rng(seed).standard_normal(shape)


@pytest.fixture(scope="module")
def logp_artifact(models, tmp_path_factory):
    """The B = 32 density's artifact: its bytes and the path they went to."""
    p = str(tmp_path_factory.mktemp("serving") / "logp.pt2")
    return serving.export_logdensity(models[0], 32, path=p), p


def test_export_logdensity_roundtrip(models, logp_artifact):
    port, ref = models
    B = 32
    v = _state((B, port.dim()), 0.5, 0)
    blob, p = logp_artifact
    live = port.batched_logdensity_fn()(torch.as_tensor(v))
    jax_lp = np.asarray(jserving.load(jserving.export_logdensity(ref, B))(jnp.asarray(v)))
    for src in (blob, p):  # bytes and file paths both load
        got = serving.load(src)(torch.as_tensor(v))
        assert torch.equal(got, live)
        np.testing.assert_allclose(got.numpy(), jax_lp, rtol=1e-12)


def test_export_with_grad_matches_autograd(models):
    port, ref = models
    B = 16
    v = _state((B, port.dim()), 0.3, 1)
    lp, g = serving.load(serving.export_logdensity(port, B, with_grad=True))(torch.as_tensor(v))
    lp_live, g_live = port.batched_logdensity_fn().value_and_grad_fn(torch.as_tensor(v))
    np.testing.assert_allclose(lp.numpy(), lp_live.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_live.numpy(), rtol=1e-11, atol=1e-13)
    j_lp, j_g = jserving.load(jserving.export_logdensity(ref, B, with_grad=True))(jnp.asarray(v))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-10, atol=1e-12)


def test_export_constrain(models):
    port, ref = models
    B = 8
    v = _state((B, port.dim()), 1.0, 2)
    out = serving.load(serving.export_constrain(port, B))(torch.as_tensor(v))
    live = port.constrain(torch.as_tensor(v))
    j_out = jserving.load(jserving.export_constrain(ref, B))(jnp.asarray(v))
    assert set(out) == set(live) == set(j_out)
    for k in live:
        assert torch.equal(out[k], live[k])
        np.testing.assert_allclose(out[k].numpy(), np.asarray(j_out[k]), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(out["w"].sum(-1).numpy(), 1.0, atol=1e-12)


@pytest.mark.parametrize("bad", ["batch", "dtype"])
def test_shape_contract_enforced(models, logp_artifact, bad):
    port, _ = models
    fn = serving.load(logp_artifact[0])
    v = (torch.zeros((16, port.dim()), dtype=F64) if bad == "batch"
         else torch.zeros((32, port.dim()), dtype=torch.float32))
    with pytest.raises(ValueError, match="the artifact takes a"):
        fn(v)


@pytest.mark.parametrize("with_grad", [False, True])
def test_transposed_export_is_the_live_density(models, with_grad):
    port, _ = models
    B = 24
    vT = torch.as_tensor(_state((port.dim(), B), 0.5, 3))
    fn = serving.load(serving.export_logdensity(port, B, with_grad=with_grad, transposed=True))
    live = port.batched_logdensity_t_fn()
    if with_grad:
        for got, want in zip(fn(vT), live.value_and_grad_fn(vT)):
            assert torch.equal(got, want)
    else:
        assert torch.equal(fn(vT), live(vT))


# ---------------------------------------------------------------------------
# the card route under fake tensors
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card_model():
    """The bench-like prior (Normal, LogNormal, Dirichlet(4), LKJ(3)) whose
    float32 tables live, as fake tensors of their shapes, on a fake
    `cuda:0`; yields (model, fake mode) and clears the caches' entries."""
    f32 = dict(device="cpu", dtype=torch.float32)
    model = Model(dists.NamedProduct.of(mu=dists.Normal(0.0, 2.0, **f32),
                                        s=dists.LogNormal(0.0, 0.5, **f32),
                                        w=dists.Dirichlet(torch.ones(4, **f32), **f32),
                                        c=dists.LKJ(3, 2.0, **f32)), device="cpu")
    u = model.unconstrainer()
    cf, loops, c0 = fk._prep(u, torch.zeros((model.dim(), 1)))
    assert loops is None  # a model of slab rows only
    runs, packed, head = fk.run_table(cf)
    items, scratch = fk.item_table(cf, loops)
    cuda = torch.device("cuda", 0)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        def fake(t):
            return torch.empty(t.shape, dtype=t.dtype, device=cuda)

        cf_card = fake(cf)
        fk._PREP_CACHE[u][(torch.float32, cuda)] = (cf_card, None, fake(c0))
        fk._TABLES[id(cf_card)] = (weakref.ref(cf_card), {
            "runs": (fake(runs), fake(packed), head),
            ("items", id(None)): (fake(items), scratch)})
    model.device = cuda
    yield model, mode
    fk._TABLES.pop(id(cf_card), None)
    del fk._PREP_CACHE[u][(torch.float32, cuda)]


@pytest.mark.parametrize("mode_, B, op", [
    ("value", 131072, "tbt.slab_value.default"),
    ("value_and_grad", 131072, "tbt.slab_value_and_grad.default"),
    ("value_and_grad", 64, "tbt.slab_value_and_grad_small.default"),
])
def test_card_route_records_the_kernels(fake_card_model, mode_, B, op):
    """The transposed density and its one-pass value and gradient, exported
    on fake `cuda` states, are one `tbt::` operator each and nothing of
    the plain version."""
    model, fake_mode = fake_card_model
    fn = model.batched_logdensity_t_fn()
    if mode_ == "value_and_grad":
        fn = fn.value_and_grad_fn
    with fake_mode:
        program = serving._program(model, fn, B, None, True)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert [t for t in targets if t.startswith("tbt.")] == [op]
    assert not any("cumsum" in t or "log1p" in t for t in targets)


def test_card_route_export_raises_with_the_kernels_disabled(fake_card_model):
    model, fake_mode = fake_card_model
    kernels.enable(False)
    try:
        with fake_mode, pytest.raises(RuntimeError, match="kernels are disabled"):
            serving._program(model, model.batched_logdensity_t_fn(), 64, None, True)
    finally:
        kernels.enable(True)
