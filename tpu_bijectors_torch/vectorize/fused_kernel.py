"""Fused whole-model log-density on the transposed (dim, B) state, PyTorch
counterpart of `tpu_bijectors/vectorize/fused_kernel.py`.

`_prep(u, vT)` turns the plan (fused_plan.py) into the (dim, NCF)
coefficient table, the loop entries' `LoopTable` (None for a model of
slab rows only) and the row sum of c0. Three wrappers evaluate the model
over the state, slab rows and loop entries in one launch: `slab_value`,
`slab_value_and_grad` and `slab_vjp`. For a CUDA tensor each launches its
kernel (kernels/csrc/fused_slab.cu) or raises; for a CPU tensor it runs the
plain version (fused_base.py).
`mega_logdensity_t` is differentiable in the state: its backward is the
vector-Jacobian kernel.
"""

from __future__ import annotations

import weakref

import torch

from .. import kernels
from ..utils import triu_dim_from_length
from .fused_base import (
    _CI,
    _MASK_COL,
    LOOP_CODES,
    NCF,
    LoopTable,
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
    share one parameter block."""
    loop = [e for e in plan if e.loop is not None]
    if not loop:
        return None
    blocks, offsets, rows = [], {}, []
    for e in loop:
        if id(e.params) not in offsets:
            offsets[id(e.params)] = sum(b.numel() for b in blocks)
            blocks.append(e.params(dtype).to(device))
        rows.append((LOOP_CODES[e.loop], e.row0, triu_dim_from_length(e.rows),
                     offsets[id(e.params)]))
    ent = torch.tensor(rows, dtype=torch.int32, device=device)
    return LoopTable(tuple(rows), ent, torch.cat(blocks), max(r[2] for r in rows))


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


def _check_cuda(vT, cf, loops, ct=None):
    """Raise unless vT (dim, B), cf (dim, NCF) [, the loop parameters and
    ct (B,)] are contiguous float32 tensors on one CUDA device."""
    if vT.device.type != "cuda":
        raise ValueError(f"the slab kernels run on CUDA tensors; got {vT.device}")
    ts = (vT, cf) if ct is None else (vT, cf, ct)
    if loops is not None:
        ts = ts + (loops.prm,)
        if loops.ent.device != vT.device or loops.ent.dtype != torch.int32:
            raise ValueError("the loop entry table must be int32 on the state's device")
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


def _launch(fn, name, vT, cf, loops, *ptrs):
    dim, B = vT.shape
    if loops is None:
        table = (None, 0, None, 0, 0)
    else:
        table = (loops.ent.data_ptr(), len(loops.entries), loops.prm.data_ptr(),
                 loops.prm.numel(), loops.kmax)
    kernels.launch(
        fn, name, vT.device, vT.data_ptr(), cf.data_ptr(), *table, *ptrs, dim, B
    )


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


class _SlabLogDensity(torch.autograd.Function):
    """slab_value with slab_vjp as its backward (the state's gradient only:
    cf and the loop parameters are constants of the model)."""

    @staticmethod
    def forward(ctx, vT, cf, loops):
        ctx.save_for_backward(vT, cf)
        ctx.loops = loops
        return slab_value(vT, cf, loops)

    @staticmethod
    def backward(ctx, ct):
        vT, cf = ctx.saved_tensors
        return slab_vjp(vT, cf, ct.contiguous(), ctx.loops), None, None


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
