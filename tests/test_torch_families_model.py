"""The whole-family model (`families`, the JAX package's
tests/test_transposed_layout.py `_mega_model`, linked dim 125) in all four
modes, and the #13 probe's plain versions, against the JAX package.

The model in float64 on the CPU: the port's plain whole-model functions
(value, value and gradient, the vector-Jacobian product through autograd,
the forward-mode product through `torch.func.jvp`) against the JAX
package's mega kernels in interpret mode and the composed path;
chip_smoke.py's copy of the model against the JAX test's. The probe in
float32: each variant's plain version against tools/transcend_probe.py's
kernel in interpret mode at B = 4096. On the CPU the port's wrappers run
the plain versions; chip_smoke.py holds the CUDA kernels to them on the
card.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import DER, VAL, _close, _pair, _port
from test_transposed_layout import _mega_model

from tpu_bijectors.vectorize import fused_kernel as jfk

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch.kernels import probe
from tpu_bijectors_torch.vectorize import fused_kernel as tfk

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the whole-family model in all four modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def families():
    d = _mega_model()
    u_j, u_t = _pair(d)
    rng = np.random.default_rng(29)
    dim = u_t.linked_vec_length
    vT = np.ascontiguousarray(0.6 * rng.standard_normal((24, dim)).T)
    dvT = np.ascontiguousarray(rng.standard_normal((24, dim)).T)
    return u_j, u_t, vT, dvT, rng.standard_normal(24)


def test_families_model_is_the_jax_model(families):
    """chip_smoke.py's `families` is the JAX test's `_mega_model`: dim 125,
    37 plan entries, the same table, loop entries and parameters."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    u_j, u_t, vT, _, _ = families
    u_c = tbt.Model(chip_smoke.families_model(td, tbt, "cpu", torch.float64),
                    device="cpu").unconstrainer()
    assert u_c.linked_vec_length == u_t.linked_vec_length == chip_smoke.FAM_DIM
    assert len(tfk._plan(u_t)) == len(jfk._plan(u_j, 1e-7) or ()) == 37
    a = tfk._prep(u_t, torch.as_tensor(vT))
    b = tfk._prep(u_c, torch.as_tensor(vT))
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert a[1].entries == b[1].entries and torch.equal(a[1].prm, b[1].prm)
    assert chip_smoke.families_rows(u_c)["lc"].start == chip_smoke.FAM_LC_ROW0


def test_families_value_and_grad_match_jax(families):
    u_j, u_t, vT, _, _ = families
    model = tbt.Model(_port(_mega_model()), device="cpu")
    lp, g = model.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    rlp, rg = jax.jit(lambda v: jfk.mega_value_and_grad_t(u_j, v, interpret=True))(
        jnp.asarray(vT))
    _close(u_t.linked_logdensity_t(torch.as_tensor(vT)), rlp, VAL)
    _close(lp, rlp, VAL)
    _close(g, rg, DER)
    # the composed path: value and autograd gradient
    w = torch.as_tensor(vT).requires_grad_(True)
    comp = u_t._linked_logdensity_t_children(w)
    (gc,) = torch.autograd.grad(comp.sum(), w)
    _close(lp, comp.detach(), VAL)
    _close(g, gc, DER)


def test_families_vjp_and_jvp_match_jax(families):
    u_j, u_t, vT, dvT, ct = families
    vj = jnp.asarray(vT)
    w = torch.as_tensor(vT).requires_grad_(True)
    (g,) = torch.autograd.grad(u_t.linked_logdensity_t(w), w, torch.as_tensor(ct))
    _close(g, jax.jit(lambda v, c: jfk.mega_vjp_t(u_j, v, c, interpret=True))(
        vj, jnp.asarray(ct)), DER)
    _, dlp = torch.func.jvp(u_t.linked_logdensity_t, (torch.as_tensor(vT),),
                            (torch.as_tensor(dvT),))
    _close(dlp, jax.jit(lambda v, d: jfk.mega_jvp_t(u_j, v, d, interpret=True))(
        vj, jnp.asarray(dvT)), DER)


# ---------------------------------------------------------------------------
# the #13 probe's plain versions against the JAX probe
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_probe():
    """tools/transcend_probe.py with every pallas_call in interpret mode
    and B = 4096, no file edited."""
    sys.path.insert(0, str(ROOT / "tools"))
    import transcend_probe as tp
    from jax.experimental import pallas as pl

    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call
    mp.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    mp.setattr(tp, "B", 4096)
    rng = np.random.default_rng(31)
    vT = rng.standard_normal((tp.DIM, 4096)).astype(np.float32)
    c = (1.0 + 1e-3 * rng.standard_normal((1, tp.W))).astype(np.float32)
    yield tp, vT, c
    mp.undo()


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_probe_plain_matches_jax_probe(jax_probe, variant):
    """float32 on both sides, within 1e-5 of the sum of |terms| (the sums
    run in another order); floor_g's g = X + 1 exactly."""
    tp, vT, c = jax_probe
    assert np.array_equal(np.asarray(probe.poly_coeffs()), tp._P)
    ref = np.asarray(tp.make_kernel(variant)(jnp.asarray(vT), jnp.asarray(c))).reshape(-1)
    got = probe.probe(variant, torch.as_tensor(vT), torch.as_tensor(c))
    if variant == "floor_g":
        got, g = got
        X = vT * c[0, np.arange(vT.shape[1]) % c.shape[1]]
        np.testing.assert_array_equal(g.numpy(), X + np.float32(1.0))
    mag = probe.magnitude(variant, torch.as_tensor(vT).double(), torch.as_tensor(c).double())
    np.testing.assert_array_less(np.abs(got.numpy() - ref), 1e-5 * mag.numpy())
