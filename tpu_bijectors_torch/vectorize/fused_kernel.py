"""Fused whole-model log-density on the transposed (dim, B) state, PyTorch
counterpart of `tpu_bijectors/vectorize/fused_kernel.py`.

`_prep(u, vT)` turns the plan (fused_plan.py) into the (dim, NCF)
coefficient table, the loop entries' `LoopTable` (None for a model of
slab rows only) and the row sum of c0. Four wrappers evaluate the model
over the state, slab rows and loop entries in one launch each, the four
modes of one CUDA kernel (kernels/csrc/fused_slab.cu): `slab_value` (lp),
`slab_value_and_grad` (lp and d lp / d vT), `slab_vjp` (d lp / d vT times
a cotangent) and `slab_jvp` (sum_rows d lp / d vT times a tangent). The
loop entries come in six kinds (fused_base.LOOP_CODES): PD dot and solve,
the Gaussian quadratic form lower and upper, the multivariate t, and the
traced entries (fused_traced.py), whose tapes the kernel interprets.
For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain version (fused_base.py). The kernel keeps the
coefficient table and row flags (64 bytes a row), the entry table and the
loop parameters in shared memory where they fit: a model of slab rows
only up to the block's 227 KB (some 3600 rows), a model with loop entries
within 100 KB together with its PD entries' per-thread scratch. Beyond
that it reads them from global memory through the read-only path, so a
model of any size launches. The value mode walks the model's RUNS instead
of its rows (`run_rows`, built once per model): maximal runs of
consecutive slab rows that share one term set, each with its rows'
coefficients packed into whole float4s (16 bytes a row for {quad}, 32
for {absv, sp}, cf's whole row for any other set), so that the term
groups are decided once a run; it stages only the runs and the packed
coefficients.
`mega_logdensity_t` is differentiable in the state: its backward is the
vector-Jacobian mode, its forward-mode derivative (`torch.func.jvp`,
`torch.autograd.forward_ad`) the jvp mode. Where a distribution parameter
carries a gradient or a forward-mode tangent (`params_carry_derivatives`),
the dispatch hooks decline and `linked_logdensity_t` takes the composed
per-leaf path, as the JAX package routes parameter tangents through its
composed path: the kernels serve the state alone.

At a sampler's batch (B <= SMALL_B, `slab_design`) the value-and-gradient
wrapper launches the item kernel instead: the model's work cut into items
(`item_rows`: groups of slab rows, loop entries, traced runs and passes,
PD column pairs), built once per model and run side by side on a block's
warps, a block a tile of 32 batch columns (kernels/csrc/fused_slab.cu).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.autograd.forward_ad as fwAD

from .. import kernels
from .fused_base import (
    _CI,
    _MASK_COL,
    _WEIGHT_OF,
    LOOP_CODES,
    NCF,
    NK,
    PARAM_FLOATS,
    PD_MODES,
    TRACED,
    LoopTable,
    slab_jvp_plain,
    slab_value_and_grad_plain,
    slab_value_plain,
    slab_vjp_plain,
)
from .fused_plan import _plan, _plan_with_reason


# unconstrainer -> {(dtype, device): (cf, loops, c0sum)}; the unconstrainers
# hash by identity (eq=False), and an entry goes with its unconstrainer
_PREP_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _loop_table(plan, dtype, device):
    """The plan's loop entries as a LoopTable, or None where it has none.
    Entries that share a parameter function (the copies of an IID block)
    share one parameter block, and traced entries that share a tape one
    program."""
    loop = [e for e in plan if e.loop is not None]
    if not loop:
        return None
    blocks, offsets, rows = [], {}, []
    words, toff_of, toffs, tapes = [], {}, [], {}
    for e in loop:
        if id(e.params) not in offsets:
            offsets[id(e.params)] = sum(b.numel() for b in blocks)
            blocks.append(e.params(dtype).to(device))
        rows.append((LOOP_CODES[e.loop], e.row0, e.k, offsets[id(e.params)]))
        if e.tape is not None and id(e.tape) not in toff_of:
            # the programs follow one offset an entry
            toff_of[id(e.tape)] = len(loop) + len(words)
            tapes[toff_of[id(e.tape)]] = e.tape
            words.extend(e.tape.words)
        toffs.append(-1 if e.tape is None else toff_of[id(e.tape)])
    ent = torch.tensor(rows, dtype=torch.int32, device=device)
    pd_k = [r[2] for r in rows if r[0] in PD_MODES]
    tape = torch.tensor(toffs + words, dtype=torch.int32, device=device) if words else None
    return LoopTable(tuple(rows), ent, torch.cat(blocks), max(pd_k, default=0), tape,
                     tuple(toffs), tapes)


def _prep(u, vT):
    """(cf (dim, NCF), loops (LoopTable or None), c0sum) in vT's dtype on
    vT's device. Memoised per unconstrainer and (dtype, device): its
    distribution parameters are fixed for the life of the object. Raises
    NotImplementedError naming a leaf with neither a slab nor a loop form,
    and ValueError on a state of the wrong shape."""
    if vT.ndim != 2:
        raise ValueError(f"the state must be (dim, B); got shape {tuple(vT.shape)}")
    cache = _PREP_CACHE.setdefault(u, {})
    key = (vT.dtype, vT.device)
    if key in cache:
        cf, loops, c0sum = cache[key]
    else:
        plan, reason = _plan_with_reason(u)
        if plan is None:
            raise NotImplementedError(
                f"the fused log-density has neither a slab nor a loop form for "
                f"{reason}; the kernels for other leaves are not ported yet"
            )
        dim = sum(e.rows for e in plan)
        cf = torch.zeros((dim, NCF), dtype=vT.dtype, device=vT.device)
        for e in plan:
            if e.slab is None:
                continue  # a loop entry's rows: not slab-owned
            rows = slice(e.row0, e.row0 + e.rows)
            cf[rows, _MASK_COL] = 1.0
            for k, v in e.slab(vT.dtype).items():
                cf[rows, _CI[k]] = v.to(vT.device)
        loops = _loop_table(plan, vT.dtype, vT.device)
        if params_carry_derivatives(u):
            raise NotImplementedError(
                "gradients with respect to distribution parameters do not "
                "pass through the fused log-density; linked_logdensity_t "
                "takes the composed path for them"
            )
        c0sum = cf[:, _CI["c0"]].sum()
        cache[key] = (cf, loops, c0sum)
        item_table(cf, loops)  # the small design's items, built once per model
        run_table(cf)  # the value mode's runs, likewise
    if vT.shape[0] != cf.shape[0]:
        raise ValueError(
            f"the state has {vT.shape[0]} rows; the model has {cf.shape[0]}"
        )
    return cf, loops, c0sum


# ---------------------------------------------------------------------------
# the small-batch design's item table
# ---------------------------------------------------------------------------

# the value-and-gradient mode takes the item kernel at B <= SMALL_B and the
# kernel of a thread a column above: the crossover of chip_smoke.py's
# `slab_small_b_sweep` on the H100 (PERF.md section 6)
SMALL_B = 16384
TILE = 32  # batch columns a block of the item kernel (kTile)
ITEM_COLS = 6  # {kind, first row, rows or K, parameter offset, tape offset, j}
ITEM_ROWS = 8  # slab rows a group item at most (kRowBlock)
TRACED_RUN = 4  # rows a run item of a traced scalar entry
SLAB_ITEM = 0  # the kind of a group of slab rows; loop items keep LOOP_CODES
PD_SCRATCH = 1392  # a PD item's floats of scratch a warp (kPdScratch)


def slab_design(B: int) -> str:
    """The value-and-gradient kernel's design at batch B: "small" (the
    item kernel) at B <= SMALL_B, else "wide" (a thread a column)."""
    return "small" if B <= SMALL_B else "wide"


def item_warps(n_items, loops):
    """A block's warps for n_items items (max_warps): at most 32 for a
    model of slab rows alone, 16 with loop entries."""
    return min(n_items, 16 if loops is not None else 32)


def _entry_rows(code, K):
    return K * (K + 1) // 2 if code in PD_MODES else K


def _entry_items(loops, i):
    """The items of loop entry i, and the floats of scratch a warp needs
    for them."""
    code, row0, K, off = loops.entries[i]
    if code == TRACED:
        toff = loops.toffs[i]
        if loops.tapes[toff].vector:
            return [(code, row0, K, off, toff, j) for j in range(K)], 0
        return [(code, a, min(TRACED_RUN, row0 + K - a), off, toff, 0)
                for a in range(row0, row0 + K, TRACED_RUN)], 0
    if code in PD_MODES:
        return [(code, row0, K, off, 0, j) for j in range(TILE // 2)], PD_SCRATCH
    return [(code, row0, K, off, 0, 0)], PARAM_FLOATS[code](K)


def item_rows(owned, loops):
    """The item kernel's items in their fixed order, as tuples {kind,
    first row, rows or K, parameter offset, tape offset, j}, and the
    floats of scratch a warp needs. `owned[r]` says whether the slab owns
    row r; `loops` is the model's LoopTable or None. In row order: a
    Gaussian or t entry is one item; a PD entry one item a pair of a
    tile's columns (j the pair); a traced scalar entry one item a run of
    TRACED_RUN rows; a traced vector entry one item a pass (j the input
    whose partial it writes; pass 0 adds the value); each run of
    consecutive slab-owned rows is cut into groups of up to ITEM_ROWS, as
    few rows a group as spread the slab rows over the warps the loop items
    leave free. Raises on a row that neither the slab nor a loop entry
    owns."""
    entries = {} if loops is None else {
        e[1]: (_entry_rows(e[0], e[2]),) + _entry_items(loops, i)
        for i, e in enumerate(loops.entries)}
    free = item_warps(1 << 30, loops) - sum(len(e[1]) for e in entries.values())
    group = ITEM_ROWS if free <= 0 else min(ITEM_ROWS, max(1, -(-sum(owned) // free)))
    out, scratch, r, dim = [], 0, 0, len(owned)
    while r < dim:
        if r in entries:
            rows, its, need = entries[r]
            out += its
            scratch = max(scratch, need)
            r += rows
        elif owned[r]:
            n = 1
            while n < group and r + n < dim and owned[r + n] and r + n not in entries:
                n += 1
            out.append((SLAB_ITEM, r, n, 0, 0, 0))
            scratch = max(scratch, group * NCF)
            r += n
        else:
            raise ValueError(f"row {r} is owned by neither the slab nor a loop entry")
    return out, scratch


# id(cf) -> (weak reference to cf, {key: table}): the tables built from a
# model's cf (`item_table`, `run_table`), kept while cf lives
_TABLES: dict = {}


def _of_cf(cf, key, build):
    """`build()`, once for cf and key, kept while cf lives."""
    hit = _TABLES.get(id(cf))
    if hit is None or hit[0]() is not cf:
        hit = (weakref.ref(cf), {})
        _TABLES[id(cf)] = hit
        weakref.finalize(cf, _TABLES.pop, id(cf), None)
    if key not in hit[1]:
        hit[1][key] = build()
    return hit[1][key]


def item_table(cf, loops):
    """(items, scratch) of the model whose table is cf: `item_rows` as an
    int32 tensor on cf's device, built at the first call for this cf (by
    `_prep`, when it builds cf) and kept while cf lives."""
    def build():
        rows, scratch = item_rows((cf[:, _MASK_COL] > 0).tolist(), loops)
        items = torch.tensor(rows, dtype=torch.int32, device=cf.device).reshape(-1, ITEM_COLS)
        return items, scratch

    return _of_cf(cf, ("items", id(loops)), build)


# ---------------------------------------------------------------------------
# the value mode's run table
# ---------------------------------------------------------------------------

RUN_COLS = 4  # {first row, rows, term set, offset of its packed coefficients}
WALK_BLOCK = 8  # rows of a run the value kernel loads at a time (walk::kBlock)
# a row's term set: the bits of csrc/fused_slab.cu::row_flags, a group's
# bit set where one of its weights is nonzero
GROUP_FLAGS = {"lin": 1, "quad": 2, "absv": 4, "sp": 8, "exp": 16, "l1p": 32}
# the term sets with a row function of their own (walk::kQuadSet,
# ::kAbsvSpSet) and the columns a row of each packs, in order; every other
# set packs cf's whole row (NCF columns in cf's order) and runs slab_row
RUN_SETS = {
    GROUP_FLAGS["quad"]: ("m", "cq"),
    GROUP_FLAGS["absv"] | GROUP_FLAGS["sp"]: ("m", "c3p", "c3n", "c4", "sa", "sb"),
}


def run_width(term_set):
    """Floats a row of a run with this term set packs (walk::width): its
    columns padded to whole float4s, 16 for a set without a row function
    of its own."""
    cols = RUN_SETS.get(term_set)
    return 16 if cols is None else -(-len(cols) // 4) * 4


def row_sets(cf):
    """Each row's term set (GROUP_FLAGS bits), None on a row the slab does
    not own."""
    nz = cf[:, :NK] != 0
    sets = sum(GROUP_FLAGS[g] * torch.stack([nz[:, _CI[k]] for k in sorted(ks)]).any(0).long()
               for g, ks in _WEIGHT_OF.items())
    owned = (cf[:, _MASK_COL] > 0).tolist()
    return [int(t) if o else None for t, o in zip(sets.tolist(), owned)]


def run_rows(cf):
    """The value kernel's runs, as tuples {first row, rows, term set, offset
    of its packed coefficients}, and the packed coefficients (a 1-D tensor
    of cf's dtype on its device). A run is a maximal run of consecutive
    slab-owned rows with one term set, in row order (a loop entry's rows,
    which the slab does not own, end a run); its rows' coefficients follow
    one another, `run_width` floats a row: the set's RUN_SETS columns, or
    cf's whole row, then zeros."""
    runs, r, sets = [], 0, row_sets(cf)
    while r < len(sets):
        if sets[r] is None:
            r += 1
            continue
        n = 1
        while r + n < len(sets) and sets[r + n] == sets[r]:
            n += 1
        runs.append((r, n, sets[r]))
        r += n
    blocks, out, off = [], [], 0
    for row0, n, t in runs:
        w = run_width(t)
        cols = RUN_SETS.get(t)
        idx = list(range(NCF)) if cols is None else [_CI[k] for k in cols]
        block = torch.zeros((n, w), dtype=cf.dtype, device=cf.device)
        block[:, :len(idx)] = cf[row0: row0 + n, idx]
        blocks.append(block.reshape(-1))
        out.append((row0, n, t, off))
        off += n * w
    packed = torch.cat(blocks) if blocks else torch.zeros(0, dtype=cf.dtype, device=cf.device)
    return out, packed


def run_table(cf):
    """(runs, packed, head) of the model whose table is cf: `run_rows` as an
    int32 (n, RUN_COLS) tensor and the packed coefficients on cf's device,
    and the first run's first block (its first row and rows, (0, 0) where
    the model has no slab row), which the kernel loads before it stages
    the tables; built at the first call for this cf (by `_prep`) and kept
    while cf lives."""
    def build():
        rows, packed = run_rows(cf)
        runs = torch.tensor(rows, dtype=torch.int32, device=cf.device).reshape(-1, RUN_COLS)
        head = (rows[0][0], min(WALK_BLOCK, rows[0][1])) if rows else (0, 0)
        return runs, packed, head

    return _of_cf(cf, "runs", build)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(vT, cf, loops, ct=None, dvT=None):
    """Raise unless vT (dim, B), cf (dim, NCF) [, the loop parameters, ct
    (B,) and dvT (dim, B)] are contiguous float32 tensors on one CUDA
    device."""
    if vT.device.type != "cuda":
        raise ValueError(f"the slab kernels run on CUDA tensors; got {vT.device}")
    ts = tuple(t for t in (vT, cf, ct, dvT) if t is not None)
    if loops is not None:
        ts = ts + (loops.prm,)
        for t in (loops.ent, loops.tape):
            if t is not None and (t.device != vT.device or t.dtype != torch.int32):
                raise ValueError("the loop entry table and the tapes must be int32 on the "
                                 "state's device")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"the slab kernels take float32; got {t.dtype}")
        if t.device != vT.device:
            raise ValueError(f"tensors on {t.device} and {vT.device}")
        if not t.is_contiguous():
            raise ValueError("the slab kernels take contiguous tensors")
    if vT.ndim != 2 or cf.shape != (vT.shape[0], NCF):
        raise ValueError(
            f"shapes vT {tuple(vT.shape)}, cf {tuple(cf.shape)}: need "
            f"(dim, B) and (dim, {NCF})"
        )
    if ct is not None and ct.shape != (vT.shape[1],):
        raise ValueError(f"ct must be ({vT.shape[1]},); got {tuple(ct.shape)}")
    if dvT is not None and dvT.shape != vT.shape:
        raise ValueError(f"dvT must be {tuple(vT.shape)}; got {tuple(dvT.shape)}")


def _launch(fn, name, vT, head, loops, *tail):
    """Launch `fn` on vT, the slab's arguments `head`, the loop table of
    `loops` and `tail`."""
    if loops is None:
        table = (None, 0, None, 0, 0, None)
    else:
        tape = None if loops.tape is None else loops.tape.data_ptr()
        table = (loops.ent.data_ptr(), len(loops.entries), loops.prm.data_ptr(),
                 loops.prm.numel(), loops.kmax, tape)
    kernels.launch(fn, name, vT.device, vT.data_ptr(), *head, *table, *tail)
    if loops is not None and loops.tapes:
        kernels.LAUNCHES["slab_traced"] += 1  # a launch that ran the traced loop kind


def slab_value(vT, cf, loops=None):
    """lp (B,) of the slab form (without c0) and the loop entries over vT
    (dim, B). On the card the slab rows are walked as the model's runs
    (`run_table`)."""
    if vT.device.type == "cpu":
        return slab_value_plain(vT, cf, loops)
    _check_cuda(vT, cf, loops)
    runs, packed, head = run_table(cf)
    lp = torch.empty(vT.shape[1], dtype=vT.dtype, device=vT.device)
    _launch("tbt_slab_value", "slab_value", vT,
            (runs.data_ptr(), runs.shape[0], *head, packed.data_ptr(), packed.numel()), loops,
            lp.data_ptr(), vT.shape[1])
    return lp


def slab_value_and_grad(vT, cf, loops=None, design=None):
    """(lp (B,), g = d lp / d vT (dim, B)) in one pass. On the card the
    design is `slab_design(B)` unless `design` ("small" or "wide") names
    one."""
    if vT.device.type == "cpu":
        return slab_value_and_grad_plain(vT, cf, loops)
    _check_cuda(vT, cf, loops)
    design = design or slab_design(vT.shape[1])
    lp = torch.empty(vT.shape[1], dtype=vT.dtype, device=vT.device)
    g = torch.empty_like(vT)
    if design == "wide":
        _launch("tbt_slab_value_and_grad", "slab_value_and_grad", vT, (cf.data_ptr(),), loops,
                lp.data_ptr(), g.data_ptr(), *vT.shape)
        return lp, g
    if design != "small":
        raise ValueError(f"design must be 'small' or 'wide'; got {design!r}")
    items, scratch = item_table(cf, loops)
    prm = tape = None
    if loops is not None:
        prm = loops.prm.data_ptr()
        tape = None if loops.tape is None else loops.tape.data_ptr()
    dim, B = vT.shape
    kernels.launch(
        "tbt_slab_value_and_grad_items", "slab_value_and_grad_small", vT.device,
        vT.data_ptr(), cf.data_ptr(), items.data_ptr(), items.shape[0], prm, tape, scratch,
        int(loops is not None), lp.data_ptr(), g.data_ptr(), dim, B,
    )
    if loops is not None and loops.tapes:
        kernels.LAUNCHES["slab_traced"] += 1
    return lp, g


def launch_floor(device):
    """Launch a kernel that does nothing on `device` (a yardstick: its time
    is the floor of any launch)."""
    kernels.launch("tbt_empty", "launch_floor", torch.device(device))


def slab_vjp(vT, cf, ct, loops=None):
    """g = (d lp / d vT) * ct (dim, B) for a cotangent ct (B,)."""
    if vT.device.type == "cpu":
        return slab_vjp_plain(vT, cf, ct, loops)
    _check_cuda(vT, cf, loops, ct)
    g = torch.empty_like(vT)
    _launch("tbt_slab_vjp", "slab_vjp", vT, (cf.data_ptr(),), loops, ct.data_ptr(),
            g.data_ptr(), *vT.shape)
    return g


def slab_jvp(vT, cf, dvT, loops=None):
    """dlp (B,) = sum over rows of (d lp / d vT) * dvT for a tangent dvT
    (dim, B)."""
    if vT.device.type == "cpu":
        return slab_jvp_plain(vT, cf, dvT, loops)
    _check_cuda(vT, cf, loops, dvT=dvT)
    dlp = torch.empty(vT.shape[1], dtype=vT.dtype, device=vT.device)
    _launch("tbt_slab_jvp", "slab_jvp", vT, (cf.data_ptr(),), loops, dvT.data_ptr(),
            dlp.data_ptr(), *vT.shape)
    return dlp


class _OnStorage(torch.autograd.Function):
    """`fn(*args)` on tensors with storage. Inside the derivative rules of
    `_SlabLogDensity`, `torch.func`'s transforms hand over tensors wrapped
    at their level, which have no data pointer for a kernel; an
    autograd.Function runs its `forward` on the unwrapped tensors. It has
    no derivative of its own: a second derivative of the fused log-density
    raises."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


class _SlabLogDensity(torch.autograd.Function):
    """slab_value with slab_vjp as its backward and slab_jvp as its
    forward-mode derivative (the state's only: cf and the loop parameters
    are constants of the model). `forward` takes no ctx, so that
    `torch.func.jvp` accepts the Function."""

    @staticmethod
    def forward(vT, cf, loops):
        return slab_value(vT, cf, loops)

    @staticmethod
    def setup_context(ctx, inputs, output):
        vT, cf, loops = inputs
        ctx.save_for_backward(vT, cf)
        ctx.save_for_forward(vT, cf)
        ctx.loops = loops

    @staticmethod
    def backward(ctx, ct):
        vT, cf = ctx.saved_tensors
        return _OnStorage.apply(slab_vjp, vT, cf, ct.contiguous(), ctx.loops), None, None

    @staticmethod
    def jvp(ctx, dvT, dcf, dloops):
        vT, cf = ctx.saved_tensors
        return _OnStorage.apply(slab_jvp, vT, cf, dvT.contiguous(), ctx.loops)


# ---------------------------------------------------------------------------
# model-level entry points and dispatch
# ---------------------------------------------------------------------------


def mega_logdensity_t(u, vT):
    """The whole model's linked log-density (B,) on vT (dim, B),
    differentiable in vT. c0 has no V dependence: its row sum is added
    after the kernel."""
    cf, loops, c0sum = _prep(u, vT)
    return _SlabLogDensity.apply(vT, cf, loops) + c0sum


def mega_value_and_grad_t(u, vT):
    """(lp (B,), g = d sum(lp) / d vT (dim, B)) in one pass: what every
    leapfrog step needs. Not differentiable further."""
    cf, loops, c0sum = _prep(u, vT)
    lp, g = slab_value_and_grad(vT, cf, loops)
    return lp + c0sum, g


# unconstrainer -> the tensors it holds (its distributions' parameters and
# any bijector's), found once
_TENSORS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _tensors_of(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors_of(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors_of(o)


def params_carry_derivatives(u) -> bool:
    """Whether a tensor of the model (a distribution's parameter) requires
    a gradient or carries a forward-mode tangent."""
    if u not in _TENSORS:
        _TENSORS[u] = tuple(_tensors_of(u))
    return any(t.requires_grad or fwAD.unpack_dual(t).tangent is not None for t in _TENSORS[u])


def _fused_applies(u, vT) -> bool:
    """Whether the fused evaluation serves vT: never where a parameter
    carries a derivative (the composed path serves it, on either device).
    Else always on the card, where
    the only alternative would be plain PyTorch standing in for kernels
    (so a leaf with neither a slab nor a loop form raises there, and
    disabled kernels raise at the launch); on the CPU, when the kernels are enabled and the model
    has a plan."""
    if params_carry_derivatives(u):
        return False
    if vT.device.type == "cuda":
        return True
    return kernels.enabled() and vT.ndim == 2 and _plan(u) is not None


def try_mega(u, vT):
    """Dispatch hook of Unconstrainer.linked_logdensity_t: the fused
    log-density, or None where the composed path serves a CPU state."""
    return mega_logdensity_t(u, vT) if _fused_applies(u, vT) else None


def try_mega_value_and_grad(u, vT):
    """Leapfrog dispatch: (lp, g) from the one-pass evaluation, or None
    where the caller differentiates the composed path of a CPU state."""
    return mega_value_and_grad_t(u, vT) if _fused_applies(u, vT) else None
