"""The whole-model value kernel's walk over runs of rows (#1,
`csrc/fused_slab.cu::walk::run_kernel`): its run table and its order of
sums.

`vectorize/fused_kernel.py::run_rows` cuts a model's slab rows into runs:
maximal runs of consecutive slab-owned rows that share one term set, each
with its rows' coefficients packed (the set's columns, or cf's whole row
for a set without a row function of its own) into whole float4s. The
kernel walks the runs in row order, eight rows of a run loaded at a time,
and adds each row's value to lp in row order, then the loop entries'. The CUDA
kernel runs only on the card, where chip_smoke.py holds it to its plain
version; here, on the CPU: the run table of every model chip_smoke.py
serves through it covers each slab row once, in order, with its flags and
its coefficients; a float64 emulation of the walk (the row functions on
the packed coefficients) gives the plain version's row values exactly and
its lp in row order, and agrees with the JAX package's
`mega_logdensity_t` in interpret mode; and the host's constants are the
source's.
"""

import re
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import ATOL, CPU64, RTOL, spec_of

import chip_smoke
from tpu_bijectors import dists as jd
from tpu_bijectors.vectorize import fused_kernel as jfk
from tpu_bijectors.vectorize import unconstrain as junconstrain

import tpu_bijectors_torch as tbt
from tpu_bijectors_torch import dists as td
from tpu_bijectors_torch.vectorize import fused_base as tfb
from tpu_bijectors_torch.vectorize import fused_kernel as tfk

# the models chip_smoke.py drives the value kernel on, and their runs (the
# families model: 17 runs over its 88 slab rows of 125)
RUN_COUNTS = {"bench": 2, "families": 17, "mvdense": 1, "pdonly": 1}
QUAD = tfk.GROUP_FLAGS["quad"]
ABSV_SP = tfk.GROUP_FLAGS["absv"] | tfk.GROUP_FLAGS["sp"]


@pytest.fixture(scope="module", params=sorted(RUN_COUNTS))
def driven(request):
    """(name, cf, loops) of a model chip_smoke.py drives, on the CPU."""
    name = request.param
    d = chip_smoke.ITEM_MODELS[name](td, tbt, "cpu", torch.float32)
    model = tbt.Model(d, device="cpu")
    cf, loops, _ = tfk._prep(model.unconstrainer(), torch.zeros(model.dim(), 1))
    return name, cf, loops


def flags(row):
    """A cf row's term set, from its weight columns (row_flags)."""
    c = {k: float(row[i]) for k, i in tfb._CI.items()}
    return ((c["c1"] != 0) * 1 + (c["cq"] != 0) * 2 + (c["c3p"] != 0 or c["c3n"] != 0) * 4
            + (c["c4"] != 0) * 8 + (c["c5"] != 0) * 16 + (c["c6"] != 0) * 32)


def test_run_table_covers_each_slab_row_once_in_order(driven):
    name, cf, loops = driven
    owned = (cf[:, tfb._MASK_COL] > 0).tolist()
    runs, packed = tfk.run_rows(cf)
    assert len(runs) == RUN_COUNTS[name]
    if name == "families":
        assert sum(n for _, n, _, _ in runs) == 88 == sum(owned) and cf.shape[0] == 125
    if name == "pdonly":
        assert [(r0, n) for r0, n, _, _ in runs] == [(136, 15)]
    seen, off, prev_end = [], 0, -1
    loop_rows = set() if loops is None else {
        r for code, r0, K, _ in loops.entries
        for r in range(r0, r0 + (K * (K + 1) // 2 if code in tfb.PD_MODES else K))}
    for i, (row0, n, t, o) in enumerate(runs):
        assert row0 > prev_end and n >= 1
        rows = range(row0, row0 + n)
        assert all(owned[r] for r in rows) and not loop_rows & set(rows)
        assert all(flags(cf[r]) == t for r in rows)
        # maximal: the next row is another set, not owned, or past the end
        end = row0 + n
        assert end == len(owned) or not owned[end] or flags(cf[end]) != t
        assert o == off
        w = tfk.run_width(t)
        cols = tfk.RUN_SETS.get(t)
        idx = list(range(tfb.NCF)) if cols is None else [tfb._CI[k] for k in cols]
        block = packed[o: o + n * w].reshape(n, w)
        assert torch.equal(block[:, :len(idx)], cf[row0:end, idx])
        assert not block[:, len(idx):].any()
        off += n * w
        prev_end = end - 1
        seen.extend(rows)
    assert seen == [r for r, o in enumerate(owned) if o] and off == packed.numel()
    # built once per model, beside cf, on its device
    table, pk, head = tfk.run_table(cf)
    assert table.dtype == torch.int32 and [tuple(r) for r in table.tolist()] == runs
    assert torch.equal(pk, packed) and tfk.run_table(cf)[0] is table
    # the first block the kernel loads: the first run's first rows
    assert head == (runs[0][0], min(tfk.WALK_BLOCK, runs[0][1]))


def test_bench_runs_are_the_two_specialised_sets():
    d = chip_smoke.ITEM_MODELS["bench"](td, tbt, "cpu", torch.float32)
    model = tbt.Model(d, device="cpu")
    cf, _, _ = tfk._prep(model.unconstrainer(), torch.zeros(model.dim(), 1))
    assert [(r0, n, t) for r0, n, t, _ in tfk.run_rows(cf)[0]] == [(0, 16, QUAD),
                                                                    (16, 135, ABSV_SP)]


def emulate(vT, cf, loops):
    """The run walk in float64: (each slab row's value (dim, B), lp (B,)).
    The rows' values come from the row functions on the packed
    coefficients ({quad}: t = cq d, t d; {absv, sp}: zguard(sel3, sel3 |d|)
    + c4 log1p(exp(sa |d| + sb)); any other set: slab_row's groups in
    order on cf's whole row); lp adds them in row order, then the loop
    entries' values in entry order."""
    runs, packed = tfk.run_rows(cf)
    vals = torch.zeros_like(vT)
    lp = torch.zeros(vT.shape[1], dtype=vT.dtype)
    names = list(tfb._WEIGHT_OF)
    for row0, n, t, off in runs:
        w = tfk.run_width(t)
        for i in range(n):
            c = packed[off + i * w: off + (i + 1) * w]
            v = vT[row0 + i]
            if t == QUAD:
                d = v - c[0]
                tt = c[1] * d
                val = tt * d
            elif t == ABSV_SP:
                d = v - c[0]
                sel3 = torch.where(d >= 0, c[1], c[2])
                val = torch.where(sel3 == 0, torch.zeros_like(d), sel3 * d.abs())
                val = val + c[3] * torch.log1p(torch.exp(c[4] * d.abs() + c[5]))
            else:
                groups = [g for b, g in enumerate(names) if t >> b & 1]
                val = tfb._slab_segment_val_par(groups, v[None], c[None, :tfb.NCF],
                                                frozenset(tfb._COEF_KEYS), value=True,
                                                skip_mask=True)[0][0]
            vals[row0 + i] = val
            lp = lp + val
    if loops is not None:
        lp = lp + tfb._loop_val_par(vT, loops, True, False)[0]
    return vals, lp


def _plain_rows(vT, cf):
    groups, used = tfb._groups_and_used(cf)
    return tfb._slab_segment_val_par(groups, vT, cf, used, value=True)[0]


def test_emulated_walk_gives_the_plain_rows_exactly(driven):
    """On the chip_smoke.py models (float64 tables): each slab row's value
    is the plain version's bit for bit, and lp is their sum in row order
    plus the loop entries, the plain version's up to the order of its sum."""
    name, _, _ = driven
    d = chip_smoke.ITEM_MODELS[name](td, tbt, "cpu", torch.float64)
    model = tbt.Model(d, device="cpu")
    rng = np.random.default_rng(3)
    vT = torch.as_tensor(0.6 * rng.standard_normal((model.dim(), 7)))
    cf, loops, _ = tfk._prep(model.unconstrainer(), vT)
    vals, lp = emulate(vT, cf, loops)
    plain = _plain_rows(vT, cf)
    owned = cf[:, tfb._MASK_COL] > 0
    assert torch.equal(vals[owned], plain[owned])
    np.testing.assert_allclose(lp.numpy(), tfb.slab_value_plain(vT, cf, loops).numpy(),
                               rtol=1e-13, atol=1e-12)


# every term set the row functions split into ({quad}, {absv, sp}, {lin,
# exp}, {absv}, {l1p}), with a PD entry between runs, small enough for the
# JAX kernel in interpret mode
def _mixed():
    return jd.NamedProduct.of(
        e=jd.IIDProduct(jd.Exponential(1.5), 3), l=jd.Laplace(0.2, 1.3), c=jd.Cauchy(0.1, 2.0),
        W=jd.Wishart(6.0, jnp.eye(3)), n=jd.Normal(0.3, 1.1),
        w=jd.Dirichlet(jnp.asarray([1.2, 0.8, 2.0])))


@lru_cache(maxsize=None)
def _mixed_case():
    d = _mixed()
    u_t = tbt.unconstrain(tbt.dist_from_spec(spec_of(d), **CPU64), device="cpu")
    u_j = junconstrain(d)
    vT = 0.6 * np.random.default_rng(5).standard_normal((u_t.linked_vec_length, 8))
    ref = jax.jit(lambda v: jfk.mega_logdensity_t(u_j, v, interpret=True))(jnp.asarray(vT))
    return u_t, vT, np.asarray(ref)


def test_emulated_walk_matches_jax_kernel():
    u_t, vT, ref = _mixed_case()
    vT = torch.as_tensor(vT)
    cf, loops, c0sum = tfk._prep(u_t, vT)
    runs = tfk.run_rows(cf)[0]
    sets = {t for _, _, t, _ in runs}
    assert {QUAD, ABSV_SP} <= sets and sets - set(tfk.RUN_SETS)  # general runs too
    assert loops is not None and len(runs) >= 3
    vals, lp = emulate(vT, cf, loops)
    np.testing.assert_allclose((lp + c0sum).numpy(), ref, rtol=RTOL, atol=ATOL)
    owned = cf[:, tfb._MASK_COL] > 0
    assert torch.equal(vals[owned], _plain_rows(vT, cf)[owned])


def test_constants_match_the_kernel_source():
    """The host's copies of the walk's constants (the run table's columns,
    the term-set bits, the specialised sets and each set's packed width)
    are the source's."""
    src = (Path(tfk.__file__).resolve().parents[1] / "kernels" / "csrc" /
           "fused_slab.cu").read_text()
    walk = src[src.index("namespace walk {"):]
    assert int(re.search(r"constexpr int kRunCols = (\d+);", walk).group(1)) == tfk.RUN_COLS
    assert int(re.search(r"constexpr int kBlock = (\d+);", walk).group(1)) == tfk.WALK_BLOCK
    enum = re.search(r"enum Flag : unsigned \{([^}]*)\}", src).group(1)
    bits = {k: int(v) for k, v in re.findall(r"k(\w+) = (\d+)u", enum)}
    assert {g: bits[g.capitalize()] for g in tfk.GROUP_FLAGS} == tfk.GROUP_FLAGS
    assert "constexpr unsigned kQuadSet = kQuad;" in walk
    assert "constexpr unsigned kAbsvSpSet = kAbsv | kSp;" in walk
    assert set(tfk.RUN_SETS) == {QUAD, ABSV_SP}
    assert "return set == kQuadSet ? 4 : (set == kAbsvSpSet ? 8 : 16);" in walk
    assert (tfk.run_width(QUAD), tfk.run_width(ABSV_SP), tfk.run_width(1 | 16)) == (4, 8, 16)


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    from tpu_bijectors_torch import kernels

    d = chip_smoke.ITEM_MODELS["bench"](td, tbt, "cpu", torch.float64)
    model = tbt.Model(d, device="cpu")
    vT = 0.5 * torch.randn(model.dim(), 3, dtype=torch.float64)
    cf, loops, _ = tfk._prep(model.unconstrainer(), vT)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(tfk.slab_value(vT, cf, loops), tfb.slab_value_plain(vT, cf, loops))
    assert kernels.LAUNCHES == before
