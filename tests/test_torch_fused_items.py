"""The small-batch design of the whole-model value-and-gradient kernel (#2):
its item table and its order of sums.

The item kernel (`csrc/fused_slab.cu::item_kernel`) runs the items of
`vectorize/fused_kernel.py::item_rows` side by side on a block's warps, a
block a tile of TILE batch columns, and sums the warps' shares of lp in
warp order. Here, on the CPU: the table of every model `chip_smoke.py`
drives covers each row and column of a tile exactly once and keeps each
loop entry whole; a traced vector entry gets one item a pass; a float64
emulation of the kernel's items and order of sums agrees with the JAX
package's `mega_value_and_grad_t` in interpret mode; and the wrapper's
choice of design. The kernel itself is held to the plain version on the
card by chip_smoke.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CPU64, spec_of
from test_torch_fused import MODELS as SLAB_MODELS
from test_torch_mv import _mega_model_mv
from test_torch_pd import MODELS as PD_MODELS
from test_torch_traced_model import MODELS as TRACED_MODELS

import chip_smoke
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch import kernels
from tpu_bijectors_torch.vectorize import fused_base as tfb
from tpu_bijectors_torch.vectorize import fused_kernel as tfk
from tpu_bijectors_torch.vectorize.fused_traced import traced_val_par

# the port's other fused tests' tolerances (float64, the same closed forms)
LP_TOL = dict(rtol=1e-12, atol=1e-12)
G_TOL = dict(rtol=1e-12, atol=1e-10)


def _owned(cf):
    return (cf[:, tfb._MASK_COL] > 0).tolist()


def _entry_rows(code, K):
    return K * (K + 1) // 2 if code in tfb.PD_MODES else K


@pytest.fixture(scope="module", params=sorted(chip_smoke.ITEM_MODELS))
def driven(request):
    """(name, cf, loops) of a model chip_smoke.py drives, on the CPU."""
    name = request.param
    d = chip_smoke.ITEM_MODELS[name](td, tbt, "cpu", torch.float32)
    model = tbt.Model(d, device="cpu")
    cf, loops, _ = tfk._prep(model.unconstrainer(), torch.zeros(model.dim(), 1))
    return name, cf, loops


def test_item_table_covers_each_row_once_and_keeps_entries_whole(driven):
    name, cf, loops = driven
    dim = cf.shape[0]
    owned = _owned(cf)
    items, scratch = tfk.item_rows(owned, loops)
    entries = {} if loops is None else {e[1]: (i, e) for i, e in enumerate(loops.entries)}
    n = np.zeros((dim, tfk.TILE), dtype=int)
    for kind, row0, k, off, toff, j in items:
        if kind == tfk.SLAB_ITEM:
            assert 1 <= k <= tfk.ITEM_ROWS and all(owned[row0: row0 + k])
            assert not any(r in entries for r in range(row0, row0 + k))
            n[row0: row0 + k] += 1
            continue
        if kind == tfb.TRACED and not loops.tapes[toff].vector:
            # a run of a scalar entry's rows, inside the entry
            first = max(r for r in entries if r <= row0)
            i, (code, e0, K, eoff) = entries[first]
            assert (code, eoff, toff) == (kind, off, loops.toffs[i])
            assert 1 <= k <= tfk.TRACED_RUN and row0 + k <= e0 + K
            n[row0: row0 + k] += 1
            continue
        i, (code, e0, K, eoff) = entries[row0]  # the whole entry
        assert (code, e0, K, eoff) == (kind, row0, k, off)
        if kind in tfb.PD_MODES:
            assert 0 <= j < tfk.TILE // 2
            n[row0: row0 + _entry_rows(kind, k), 2 * j: 2 * j + 2] += 1
        elif kind == tfb.TRACED:  # pass j of a vector entry writes row j
            assert toff == loops.toffs[i] and 0 <= j < k
            n[row0 + j] += 1
        else:
            n[row0: row0 + k] += 1
    assert (n == 1).all(), f"{name}: rows written other than once: {np.argwhere(n != 1)[:5]}"
    kinds = {it[0] for it in items}
    assert scratch >= (tfk.PD_SCRATCH if kinds & set(tfb.PD_MODES) else 0)
    group = max((k for kind, _, k, *_ in items if kind == tfk.SLAB_ITEM), default=0)
    assert scratch >= group * tfb.NCF
    # built once per model, beside cf, on its device
    t, s = tfk.item_table(cf, loops)
    assert t.dtype == torch.int32 and t.shape == (len(items), tfk.ITEM_COLS) and s == scratch
    assert tfk.item_table(cf, loops)[0] is t
    assert [tuple(r) for r in t.tolist()] == items


@pytest.mark.parametrize("name", ["generic-traced", "vector-leaves"])
def test_vector_entries_get_one_item_a_pass(name):
    d = chip_smoke.ITEM_MODELS[name](td, tbt, "cpu", torch.float32)
    model = tbt.Model(d, device="cpu")
    cf, loops, _ = tfk._prep(model.unconstrainer(), torch.zeros(model.dim(), 1))
    items, _ = tfk.item_rows(_owned(cf), loops)
    vec = [(i, e) for i, e in enumerate(loops.entries) if loops.tapes[loops.toffs[i]].vector]
    assert vec
    for i, (code, row0, K, _) in vec:
        passes = [it for it in items if it[0] == code and it[4] == loops.toffs[i]]
        assert [it[5] for it in passes] == list(range(K))
        assert all((it[1], it[2]) == (row0, K) for it in passes)


def emulate(vT, cf, loops):
    """The item kernel's lp (B,) and g (dim, B) in float64: each item's
    share of lp and its rows of g from the plain pieces (fused_base.py,
    fused_traced.py), a PD item on its pair of each tile's columns and a
    vector pass adding the value only at pass 0; warp w's share sums its
    items w, w + W, ... in order, and lp the warps' shares in warp order."""
    B = vT.shape[1]
    items, _ = tfk.item_rows(_owned(cf), loops)
    W = tfk.item_warps(len(items), loops)
    share = torch.zeros((W, B), dtype=vT.dtype)
    g = torch.full_like(vT, float("nan"))
    cols = torch.arange(B)
    groups, used = tfb._groups_and_used(cf)
    for it, (kind, row0, k, off, toff, j) in enumerate(items):
        w = it % W
        if kind == tfk.SLAB_ITEM:
            rows = slice(row0, row0 + k)
            val, par = tfb._slab_segment_val_par(groups, vT[rows], cf[rows], used, value=True,
                                                 partial=True, skip_mask=True)
            for r in range(k):
                share[w] += val[r]
            g[rows] = par
        elif kind in tfb.PD_MODES:
            pair = (cols % tfk.TILE) // 2 == j
            rows = slice(row0, row0 + _entry_rows(kind, k))
            blk = loops.prm[off: off + tfb.PARAM_FLOATS[kind](k)]
            val, par = tfb._pd_val_par(vT[rows][:, pair].T, blk, k, kind, True, True)
            share[w, pair] += val
            g[rows, pair] = par
        elif kind == tfb.TRACED:
            tape = loops.tapes[toff]
            consts = loops.prm[off: off + len(tape.consts)]
            rows = slice(row0, row0 + k)
            if tape.vector:
                val, par = traced_val_par(tape, consts, vT[rows], True, True)
                if j == 0:
                    share[w] += val
                g[row0 + j] = par[j]
            else:
                for r in range(row0, row0 + k):
                    val, par = traced_val_par(tape, consts, vT[r: r + 1], True, True)
                    share[w] += val
                    g[r] = par[0]
        else:
            rows = slice(row0, row0 + k)
            blk = loops.prm[off: off + tfb.PARAM_FLOATS[kind](k)]
            val, par = tfb._quad_val_par(vT[rows], blk, k, kind, True, True)
            share[w] += val
            g[rows] = par
    lp = share[0].clone()
    for w in range(1, W):
        lp = lp + share[w]
    return lp, g


# models with every item kind, at small K (<= 4 for the PD and Gaussian
# entries, as the JAX package's interpret mode is kept small)
EMULATED = {
    "bench": lambda: SLAB_MODELS["bench"](),
    "matrixy": lambda: PD_MODELS["matrixy"](),
    "mv": _mega_model_mv,
    **{k: TRACED_MODELS[k] for k in ("generic-traced", "truncated-leaves", "vector-leaves")},
}


_REF = {}


def _case(name):
    """(u_t, states (dim, 37), the JAX kernel's (lp, g) on them), once a
    model: the JAX kernel treats each column alone, so its first 8 columns
    are its answer at B = 8 on the same numpy-seeded states."""
    if name not in _REF:
        d = EMULATED[name]()
        u_t = tbt.unconstrain(tbt.dist_from_spec(spec_of(d), **CPU64), device="cpu")
        rng = np.random.default_rng(11)
        vT = np.ascontiguousarray(0.6 * rng.standard_normal((37, u_t.linked_vec_length)).T)
        ref = jfk.mega_value_and_grad_t(junconstrain(d), jnp.asarray(vT), interpret=True)
        _REF[name] = u_t, vT, tuple(np.asarray(r) for r in ref)
    return _REF[name]


@pytest.mark.parametrize("B", [8, 37])
@pytest.mark.parametrize("name", sorted(EMULATED))
def test_emulated_item_order_matches_jax_kernel(name, B):
    u_t, vT, (ref_lp, ref_g) = _case(name)
    vT = np.ascontiguousarray(vT[:, :B])
    cf, loops, c0sum = tfk._prep(u_t, torch.as_tensor(vT))
    lp, g = emulate(torch.as_tensor(vT), cf, loops)
    np.testing.assert_allclose((lp + c0sum).numpy(), ref_lp[:B], **LP_TOL)
    np.testing.assert_allclose(g.numpy(), ref_g[:, :B], **G_TOL)


def test_constants_match_the_kernel_source():
    """The host's copies of the item kernel's constants (tile width, item
    columns, rows a group, PD scratch, warps a block) are the source's."""
    src = (Path(tfk.__file__).resolve().parents[1] / "kernels" / "csrc" /
           "fused_slab.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kTile"), const("kCols"), const("kRowBlock")) == (
        tfk.TILE, tfk.ITEM_COLS, tfk.ITEM_ROWS)
    assert f"static_assert(kPdScratch == {tfk.PD_SCRATCH}" in src
    assert "return loops ? 16 : 32;" in src
    assert (tfk.item_warps(99, None), tfk.item_warps(99, object())) == (32, 16)


def test_design_choice():
    """The small design at B <= SMALL_B, the kernel of a thread a column
    above, without a launch."""
    assert tfk.slab_design(1) == tfk.slab_design(64) == tfk.slab_design(tfk.SMALL_B) == "small"
    assert tfk.slab_design(tfk.SMALL_B + 1) == tfk.slab_design(131072) == "wide"


def test_cpu_wrapper_runs_the_plain_version_whichever_design():
    d = chip_smoke.ITEM_MODELS["pdonly"](td, tbt, "cpu", torch.float64)
    model = tbt.Model(d, device="cpu")
    vT = 0.5 * torch.randn(model.dim(), 5, dtype=torch.float64)
    cf, loops, _ = tfk._prep(model.unconstrainer(), vT)
    before = dict(kernels.LAUNCHES)
    ref = tfb.slab_value_and_grad_plain(vT, cf, loops)
    for design in (None, "small", "wide"):
        lp, g = tfk.slab_value_and_grad(vT, cf, loops, design=design)
        assert torch.equal(lp, ref[0]) and torch.equal(g, ref[1])
    assert kernels.LAUNCHES == before
