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
model of any size launches.
`mega_logdensity_t` is differentiable in the state: its backward is the
vector-Jacobian mode, its forward-mode derivative (`torch.func.jvp`,
`torch.autograd.forward_ad`) the jvp mode.
"""

from __future__ import annotations

import weakref

import torch

from .. import kernels
from .fused_base import (
    _CI,
    _MASK_COL,
    LOOP_CODES,
    NCF,
    PD_MODES,
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
        if cf.requires_grad or (loops is not None and loops.prm.requires_grad):
            raise NotImplementedError(
                "gradients with respect to distribution parameters do not "
                "pass through the fused log-density"
            )
        c0sum = cf[:, _CI["c0"]].sum()
        cache[key] = (cf, loops, c0sum)
    if vT.shape[0] != cf.shape[0]:
        raise ValueError(
            f"the state has {vT.shape[0]} rows; the model has {cf.shape[0]}"
        )
    return cf, loops, c0sum


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


def _launch(fn, name, vT, cf, loops, *ptrs):
    dim, B = vT.shape
    if loops is None:
        table = (None, 0, None, 0, 0, None)
    else:
        tape = None if loops.tape is None else loops.tape.data_ptr()
        table = (loops.ent.data_ptr(), len(loops.entries), loops.prm.data_ptr(),
                 loops.prm.numel(), loops.kmax, tape)
    kernels.launch(
        fn, name, vT.device, vT.data_ptr(), cf.data_ptr(), *table, *ptrs, dim, B
    )
    if loops is not None and loops.tapes:
        kernels.LAUNCHES["slab_traced"] += 1  # a launch that ran the traced loop kind


def slab_value(vT, cf, loops=None):
    """lp (B,) of the slab form (without c0) and the loop entries over vT
    (dim, B)."""
    if vT.device.type == "cpu":
        return slab_value_plain(vT, cf, loops)
    _check_cuda(vT, cf, loops)
    lp = torch.empty(vT.shape[1], dtype=vT.dtype, device=vT.device)
    _launch("tbt_slab_value", "slab_value", vT, cf, loops, lp.data_ptr())
    return lp


def slab_value_and_grad(vT, cf, loops=None):
    """(lp (B,), g = d lp / d vT (dim, B)) in one pass."""
    if vT.device.type == "cpu":
        return slab_value_and_grad_plain(vT, cf, loops)
    _check_cuda(vT, cf, loops)
    lp = torch.empty(vT.shape[1], dtype=vT.dtype, device=vT.device)
    g = torch.empty_like(vT)
    _launch(
        "tbt_slab_value_and_grad", "slab_value_and_grad", vT, cf, loops,
        lp.data_ptr(), g.data_ptr(),
    )
    return lp, g


def slab_vjp(vT, cf, ct, loops=None):
    """g = (d lp / d vT) * ct (dim, B) for a cotangent ct (B,)."""
    if vT.device.type == "cpu":
        return slab_vjp_plain(vT, cf, ct, loops)
    _check_cuda(vT, cf, loops, ct)
    g = torch.empty_like(vT)
    _launch("tbt_slab_vjp", "slab_vjp", vT, cf, loops, ct.data_ptr(), g.data_ptr())
    return g


def slab_jvp(vT, cf, dvT, loops=None):
    """dlp (B,) = sum over rows of (d lp / d vT) * dvT for a tangent dvT
    (dim, B)."""
    if vT.device.type == "cpu":
        return slab_jvp_plain(vT, cf, dvT, loops)
    _check_cuda(vT, cf, loops, dvT=dvT)
    dlp = torch.empty(vT.shape[1], dtype=vT.dtype, device=vT.device)
    _launch("tbt_slab_jvp", "slab_jvp", vT, cf, loops, dvT.data_ptr(), dlp.data_ptr())
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


def _fused_applies(u, vT) -> bool:
    """Whether the fused evaluation serves vT. Always on the card, where
    the only alternative would be plain PyTorch standing in for kernels
    (so a leaf with neither a slab nor a loop form raises there, and
    disabled kernels raise at the launch); on the CPU, when the kernels are enabled and the model
    has a plan."""
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
