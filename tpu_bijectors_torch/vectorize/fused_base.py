"""The slab closed form of the whole-model fused evaluation, PyTorch
counterpart of `tpu_bijectors/vectorize/fused_base.py`, and the PLAIN
versions of the four slab kernels (`fused_kernel.py`, `kernels/csrc/`).

With D = V - m and U = |D|, every slab row's linked log-density is exactly

  lp_row = c0 + c1*V + cq*D^2 + where(D>=0, c3p, c3n)*U
         + c4*softplus(sa*U + sb) + c5*exp(ea*V + eb) + c6*log1p((la*D)^2)

with sa <= 0, so the softplus argument is <= 0 and softplus is
log1p(exp(.)) without overflow. The (dim, NCF) coefficient table holds
one row per state row: the 14 coefficient columns and a trailing
OWNERSHIP column. A row whose ownership is 0 has V masked to 0 before any
term is formed, and every term of a zero coefficient is an exact 0
(`_zguard`), even where V = +/-inf.

A LOOP entry owns rows no slab covers (ownership 0, every coefficient 0,
so the slab form gives them 0 and no partial). `LoopTable` packs a
model's loop entries once; the plain versions add each entry's value and
write its partials, as the JAX package's `fused_emit.py` assembles them:

- PD (`_emit_pd`, `_partials_pd`; Wishart dot, InverseWishart solve),
  from `kernels/pd.py`'s plain versions: logJ + w sum_r y_rr - tr / 2 +
  const; partials -d tr/dy / 2 plus (K+1-r) + w on the diagonal slots;
- Gaussian quadratic form (`_emit_gauss_quad`, `_partials_gauss_quad`;
  lower for MvNormalTril with C = L^-1, upper for MvNormalCanon with
  C = chol(J)'), only C's static triangle read: w = C (v - mu),
  lp = -||w||^2 / 2 + const, d lp / dv = -C'w;
- multivariate t (`_emit_mvt`, `_partials_mvt`; MvStudentT, C = L^-1
  lower): q = ||w||^2, lp = const - (df + K)/2 log1p(q / df),
  d lp / dv = -(df + K) / (df + q) C'w;
- traced (`fused_traced.py`'s `_traced_scalar_entry` and
  `_traced_vector_entry`): a leaf with no closed form, its linked density
  a tape of scalar opcodes over its rows, its constants the parameter
  block, its partials from dual numbers (`fused_traced.traced_val_par`).

The fourth plain version, `slab_jvp_plain`, is the forward-mode product
sum_rows (d lp / d vT) dvT of every row, slab and loop alike.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from ..kernels.pd import affine_coeffs, pd_logdensity_plain, pd_trace_grad_plain

LOG2 = math.log(2.0)
LOG2PI = math.log(2.0 * math.pi)
LOGPI = math.log(math.pi)


class _Unsupported(Exception):
    """A leaf with no slab form; the message names it."""


@dataclass(frozen=True)
class _Entry:
    """One entry of a plan (`fused_plan.py`): the rows it owns and either
    its slab coefficients or its loop kind with its parameter block."""

    row0: int  # first state row
    rows: int  # rows consumed
    slab: Callable | None = None  # (dtype) -> {coefficient key: (rows,) tensor}
    loop: str | None = None  # a loop entry's kind (LOOP_CODES)
    # loop entry: (dtype) -> its parameter block as a flat tensor
    # (PARAM_FLOATS): PD [C (K*K, row-major), w, const]; Gaussian [C, mu,
    # const]; t [C, mu, df, const]; traced: the tape's constants
    params: Callable | None = None
    k: int = 0  # a loop entry's K (a traced entry's rows)
    tape: object = None  # a traced entry's fused_traced.Tape


_COEF_KEYS = (
    "m", "c0", "c1", "cq", "c3p", "c3n", "c4", "sa", "sb", "c5", "ea", "eb",
    "c6", "la",
)
_CI = {k: i for i, k in enumerate(_COEF_KEYS)}
NK = len(_COEF_KEYS)
_MASK_COL = NK  # trailing slab-ownership column
NCF = NK + 1

# one term group per WEIGHT key; the auxiliary columns (m, sa, sb, ea, eb,
# la) ride with their weight key's group, and c0 (no V dependence) is
# summed outside the evaluation
_WEIGHT_OF = {
    "lin": frozenset({"c1"}),
    "quad": frozenset({"cq"}),
    "absv": frozenset({"c3p", "c3n"}),
    "sp": frozenset({"c4"}),
    "exp": frozenset({"c5"}),
    "l1p": frozenset({"c6"}),
}


def _zguard(c, term):
    """Exact 0 on zero-coefficient rows even at V = +/-inf (0 * inf would
    be NaN); rows with a finite coefficient keep the exact term."""
    return torch.where(c == 0.0, torch.zeros_like(term), term)


def _slab_mask_v(V, cf):
    """Zero the V of rows the slab does not own (ownership column 0)."""
    return torch.where(cf[:, _MASK_COL][:, None] > 0, V, torch.zeros_like(V))


def _slab_segment_val_par(
    groups, V, cf, used, *, value=True, partial=False, skip_mask=False
):
    """Every term group in `groups` over the rows of V (cf sliced to the
    same rows), each group evaluated on its own. Returns (val, par), each
    (rows, B) summed over the groups, or None when not requested. With
    both requested each group shares its transcendental between the value
    and the derivative (softplus' = sigmoid through the same exp). `used`
    names the coefficient keys assigned on these rows (a missing m/sb/eb is
    structurally 0, so its subtract/add is skipped); `skip_mask` says every
    row is slab-owned. Tie convention of the partials: sign(0) = 0."""
    val_acc = par_acc = None
    for g in groups:
        val, par = _group_val_par(g, V, cf, used, value, partial, skip_mask)
        if val is not None:
            val_acc = val if val_acc is None else val_acc + val
        if par is not None:
            par_acc = par if par_acc is None else par_acc + par
    return val_acc, par_acc


def _group_val_par(group, V, cf, used, value, partial, skip_mask):
    def col(k):
        return cf[:, _CI[k]][:, None]

    Vm = V if skip_mask else _slab_mask_v(V, cf)
    D = (Vm - col("m")) if "m" in used else Vm
    val = par = None
    if group == "lin":
        c1 = col("c1")
        if value:
            val = _zguard(c1, c1 * Vm)
        if partial:
            par = c1.expand(Vm.shape)
    elif group == "quad":
        cq = col("cq")
        t = cq * D
        if value:
            val = _zguard(cq, t * D)
        if partial:
            par = _zguard(cq, 2.0 * t)
    elif group == "absv":
        sel3 = torch.where(D >= 0, col("c3p"), col("c3n"))
        if value and partial:
            s = sel3 * torch.sign(D)  # the derivative; s*D == sel3*|D|
            val = _zguard(sel3, s * D)
            par = s
        elif value:
            val = _zguard(sel3, sel3 * torch.abs(D))
        else:
            par = sel3 * torch.sign(D)
    elif group == "sp":
        c4 = col("c4")
        sp_arg = col("sa") * torch.abs(D)
        if "sb" in used:
            sp_arg = sp_arg + col("sb")
        # sp_arg <= 0: e = exp(sp_arg) lies in (0, 1]; softplus is
        # log1p(e) and sigmoid is e / (1 + e)
        e = torch.exp(sp_arg)
        if value:
            val = _zguard(c4, c4 * torch.log1p(e))
        if partial:
            par = _zguard(c4, c4 * col("sa") * torch.sign(D) * (e / (1.0 + e)))
    elif group == "exp":
        c5 = col("c5")
        e_arg = col("ea") * Vm
        if "eb" in used:
            e_arg = e_arg + col("eb")
        e = torch.exp(e_arg)
        if value:
            val = _zguard(c5, c5 * e)
        if partial:
            par = _zguard(c5, c5 * col("ea") * e)
    elif group == "l1p":
        c6 = col("c6")
        la = col("la")
        t = la * D
        t2 = t * t
        if value:
            val = _zguard(c6, c6 * torch.log1p(t2))
        if partial:
            par = _zguard(c6, c6 * (2.0 * la * la * D) / (1.0 + t2))
    else:
        raise KeyError(group)
    return val, par


# cf -> its (groups, used), kept while cf lives: read from the host once
# a table, not once a call, so that a traced export of the plain version
# reads no host value
_GROUPS = WeakTensorKeyDictionary()


def _groups_and_used(cf):
    """The term groups and coefficient keys that `cf` assigns anywhere."""
    hit = _GROUPS.get(cf)
    if hit is None:
        nz = (cf[:, :NK] != 0).any(dim=0).tolist()
        used = frozenset(k for k, on in zip(_COEF_KEYS, nz) if on)
        hit = _GROUPS[cf] = (tuple(g for g, ks in _WEIGHT_OF.items() if ks & used), used)
    return hit


# the loop kinds' codes in the kernel's entry table (csrc/fused_slab.cu)
LOOP_CODES = {"pd_dot": 1, "pd_solve": 2, "gauss_lower": 3, "gauss_upper": 4, "mvt": 5,
              "traced": 6}
TRACED = LOOP_CODES["traced"]
PD_MODES = {1: "dot", 2: "solve"}
# floats of a loop entry's parameter block at K, by code
PARAM_FLOATS = {
    1: lambda K: K * K + 2,  # C, w, const
    2: lambda K: K * K + 2,
    3: lambda K: K * K + K + 1,  # C, mu, const
    4: lambda K: K * K + K + 1,
    5: lambda K: K * K + K + 2,  # C, mu, df, const
}


@dataclass(frozen=True)
class LoopTable:
    """A model's loop entries, packed once: `entries` holds one (code,
    first row, K, offset into prm) per entry (`LOOP_CODES`); `ent` is the
    same as an (n, 4) int32 tensor and `prm` the entries' parameter
    blocks, both on the state's device; `kmax` is the largest K of the PD
    entries (0 where there is none), which sizes the kernel's per-thread
    scratch. `tape` holds the traced entries' programs (int32, None where
    there is none): n offsets, then the programs, entry e's at
    tape[tape[e]]; `toffs` holds those offsets on the host (-1 but for a
    traced entry) and `tapes` maps an offset to its fused_traced.Tape."""

    entries: tuple
    ent: torch.Tensor
    prm: torch.Tensor
    kmax: int
    tape: torch.Tensor | None = None
    toffs: tuple = ()
    tapes: dict | None = None


def _pd_val_par(y, blk, K, code, value, partial):
    C, w, const = blk[: K * K].reshape(K, K), blk[K * K], blk[K * K + 1]
    mode = PD_MODES[code]
    val = par = None
    if value:
        logJ, sumd, tr = pd_logdensity_plain(y, K, C, mode)
        val = logJ + w * sumd - 0.5 * tr + const
    if partial:
        coeff, diag = affine_coeffs(K, y)
        par = (-0.5 * pd_trace_grad_plain(y, K, C, mode) + (coeff + w * diag)).T
    return val, par


def _quad_val_par(vT, blk, K, code, value, partial):
    """The Gaussian and t loop entries on their (K, B) rows."""
    C = blk[: K * K].reshape(K, K)
    C = torch.triu(C) if code == LOOP_CODES["gauss_upper"] else torch.tril(C)
    mu = blk[K * K : K * K + K]
    w = C @ (vT - mu[:, None])
    q = torch.sum(w * w, 0)
    if code == LOOP_CODES["mvt"]:
        df, const = blk[K * K + K], blk[K * K + K + 1]
        val = const - 0.5 * (df + K) * torch.log1p(q / df) if value else None
        par = (-(df + K) / (df + q)) * (C.T @ w) if partial else None
    else:
        val = -0.5 * q + blk[K * K + K] if value else None
        par = -(C.T @ w) if partial else None
    return val, par


def _loop_val_par(vT, loops, value, partial):
    """Each loop entry of `loops` over vT: (the sum of their values (B,) or
    None, [(rows slice, partials (rows, B))] or None)."""
    from .fused_traced import traced_val_par

    val, pars = None, []
    for i, (code, row0, K, off) in enumerate(loops.entries):
        if code == TRACED:
            tape = loops.tapes[loops.toffs[i]]
            rows = slice(row0, row0 + K)
            v, p = traced_val_par(tape, loops.prm[off: off + len(tape.consts)], vT[rows],
                                  value, partial)
            if value:
                val = v if val is None else val + v
            if partial:
                pars.append((rows, p))
            continue
        blk = loops.prm[off : off + PARAM_FLOATS[code](K)]
        if code in PD_MODES:
            rows = slice(row0, row0 + K * (K + 1) // 2)
            v, p = _pd_val_par(vT[rows].T, blk, K, code, value, partial)
        else:
            rows = slice(row0, row0 + K)
            v, p = _quad_val_par(vT[rows], blk, K, code, value, partial)
        if value:
            val = v if val is None else val + v
        if partial:
            pars.append((rows, p))
    return val, (pars if partial else None)


def _plain(vT, cf, value, partial, loops=None):
    groups, used = _groups_and_used(cf)
    val, par = _slab_segment_val_par(
        groups, vT, cf, used, value=value, partial=partial
    )
    val = torch.zeros_like(vT).sum(0) if val is None else val.sum(0)
    if par is None:
        par = torch.zeros_like(vT)
    if loops is not None:
        lval, lpars = _loop_val_par(vT, loops, value, partial)
        if lval is not None:
            val = val + lval
        if lpars:
            par = par.clone()
            for rows, p in lpars:
                par[rows] = p
    return val, par


def slab_value_plain(vT, cf, loops=None):
    """Plain version of the value kernel: lp (B,) = sum over rows of the
    slab form without c0, plus each loop entry of `loops` (a LoopTable or
    None), for vT (dim, B) and cf (dim, NCF)."""
    return _plain(vT, cf, True, False, loops)[0]


def slab_value_and_grad_plain(vT, cf, loops=None):
    """Plain version of the value-and-gradient kernel: (lp (B,), g (dim, B))
    with g = d lp / d vT."""
    return _plain(vT, cf, True, True, loops)


def slab_vjp_plain(vT, cf, ct, loops=None):
    """Plain version of the vector-Jacobian kernel: g = (d lp / d vT) * ct,
    ct (B,)."""
    return _plain(vT, cf, False, True, loops)[1] * ct


def slab_jvp_plain(vT, cf, dvT, loops=None):
    """Plain version of the forward-mode kernel: dlp (B,) = sum over rows
    of (d lp / d vT) * dvT, slab rows and loop entries alike."""
    return (_plain(vT, cf, False, True, loops)[1] * dvT).sum(0)
