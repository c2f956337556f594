"""The plan of the fused whole-model evaluation, PyTorch counterpart of
`tpu_bijectors/vectorize/fused_plan.py`: `_plan(u)` maps every leaf of an
unconstrainer tree onto a SLAB entry (per-row coefficients of the closed
form in fused_base.py) or a LOOP entry (a block of rows with its own
parameters, evaluated by a loop body in the kernel), or returns None when
a leaf has neither.

Slab forms ported: Normal (identity link) and LogNormal (log link, the
telescoped density), alone or as IID blocks with scalar parameters; the
telescoped Dirichlet; the LKJ weighted logcosh. Loop forms ported: the PD
entry of Wishart (`pd_dot`) and InverseWishart (`pd_solve`), K <= 16
(`fused_emit.py::_emit_pd`). Every other leaf raises `_Unsupported`
naming it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from ..bijectors.base import Identity
from ..bijectors.corr import VecCorrBijector
from ..bijectors.pd import PDVecBijector
from ..bijectors.simplex import SimplexBijector
from ..dists import matrix as mx
from ..dists import univariate as uv
from ..dists.multivariate import Dirichlet
from ..kernels.pd import MAX_K
from ..utils import _triu_index_arrays
from .fused_base import LOG2, LOG2PI, _Unsupported


@dataclass(frozen=True)
class _Entry:
    row0: int  # first state row
    rows: int  # rows consumed
    slab: Callable | None = None  # (dtype) -> {coefficient key: (rows,) tensor}
    loop: str | None = None  # a loop entry's kind (fused_base.LOOP_CODES)
    # loop entry: (dtype) -> its parameter block as a flat tensor, for PD
    # [C (K*K, row-major), w, const]
    params: Callable | None = None


def _scalar_entry(dist, link, n, row0):
    """Slab coefficients of a scalar family; they encode the composed
    path's math exactly, up to float reassociation."""
    t = type(dist)
    params = [getattr(dist, p) for p in dist._params]
    if any(p.ndim != 0 for p in params):
        raise _Unsupported(f"{t.__name__} with non-scalar parameters")

    def entry(fn):
        def slab(dtype):
            return {k: v.to(dtype).expand(n) for k, v in fn(dtype).items()}

        return _Entry(row0, n, slab)

    if t is uv.Normal and type(link) is Identity:

        def cf(dtype, d=dist):
            sig = d.scale.to(dtype)
            inv_s = 1.0 / sig
            return {"m": d.loc.to(dtype), "cq": -0.5 * inv_s * inv_s,
                    "c0": -0.5 * LOG2PI - torch.log(sig)}

        return entry(cf)
    if t is uv.LogNormal and uv._is_log_link(link):

        def cf(dtype, d=dist):
            sig = d.sigma.to(dtype)
            inv_s = 1.0 / sig
            return {"m": d.mu.to(dtype), "cq": -0.5 * inv_s * inv_s,
                    "c0": -0.5 * LOG2PI - torch.log(sig)}

        return entry(cf)
    raise _Unsupported(f"{t.__name__} with link {type(link).__name__}")


def _lkj_weights(K, eta):
    """Per-slot weight w_s with lp = -sum_s w_s logcosh(y_s) + const: the
    closed-form logJ coefficient K - i (corr.jl:474-483) plus the density's
    column weight 2(eta - 1)."""
    rows, _ = _triu_index_arrays(K, 1)
    base = torch.as_tensor(K - rows, dtype=eta.dtype, device=eta.device)
    return base + 2.0 * (eta - 1.0)


def _leaf_entry(leaf, row0):
    d, b = leaf.dist, leaf.link
    if leaf.event_shape == () and leaf.linked_shape == ():
        return _scalar_entry(d, b, 1, row0)
    t = type(d)
    if t is Dirichlet and type(b) is SimplexBijector and d.alpha.ndim == 1:
        K = int(d.alpha.shape[-1])

        def slab(dtype, d=d, K=K):
            # TELESCOPED form: with t_k = y_k - log(K-1-k),
            #   lp = sum_k -(1+a_k) sp(-t_k) - (K-1-k + A_k) sp(t_k) + const,
            # a = alpha - 1, A_k = sum_{m>k} a_m; sp(+-D) = relu(+-D) + sp(-U)
            # gives c3p = -w2, c3n = -w1, c4 = -(w1+w2), sa = -1. This is the
            # UN-NUDGED density: no x is formed, so the reference's eps-nudge
            # (applied by the composed path) is not needed here.
            al = d.alpha.to(dtype)
            a = al - 1.0
            const = torch.lgamma(al.sum()) - torch.lgamma(al).sum()
            ks = torch.arange(K - 1, dtype=dtype, device=al.device)
            A = torch.flip(torch.cumsum(torch.flip(a, (0,)), 0), (0,))[1:]
            w1 = 1.0 + a[: K - 1]
            w2 = (K - 1.0) - ks + A
            e0 = torch.zeros(K - 1, dtype=dtype, device=al.device)
            e0[0] = 1.0
            return {
                "m": torch.log((K - 1.0) - ks),
                "c3p": -w2,
                "c3n": -w1,
                "c4": -(w1 + w2),
                "sa": torch.full_like(w1, -1.0),
                "c0": const * e0,
            }

        return _Entry(row0, K - 1, slab)
    if t is mx.LKJ and type(b) is VecCorrBijector and d.eta.ndim == 0:
        # the whole LKJ contribution telescopes to one weighted logcosh sum
        # over the packed slots: logcosh(y) = |y| + sp(-2|y|) - log 2 maps
        # onto (c3, c4/sa, c0); d lp/d y_s = -w_s tanh(y_s) falls out of the
        # same coefficients
        K = int(d.dim)
        P = K * (K - 1) // 2

        def slab(dtype, d=d, K=K, P=P):
            eta = d.eta.to(dtype)
            w = _lkj_weights(K, eta)
            const = -mx._lkj_log_normalizer(K, eta)
            e0 = torch.zeros(P, dtype=dtype, device=eta.device)
            e0[0] = 1.0
            return {"c3p": -w, "c3n": -w, "c4": -w,
                    "sa": torch.full_like(w, -2.0),
                    "c0": w * LOG2 + const * e0}

        return _Entry(row0, P, slab)
    if t in (mx.Wishart, mx.InverseWishart) and type(b) is PDVecBijector:
        return _pd_entry(d, row0)
    raise _Unsupported(f"{t.__name__} with link {type(b).__name__}")


def _pd_entry(d, row0):
    """The PD loop entry (`fused_plan.py:520-568` of the JAX package): the
    density is logJ + w sum_r y_rr - tr / 2 + const with the family's
    `pd_terms`: C = S^-1 (dot mode, symmetrised) and w = v - K - 1 for
    Wishart; C = chol(Psi) (solve mode) and w = -(v + K + 1) for
    InverseWishart."""
    K = int(d.event_shape[-1])
    if d._matrix().ndim != 2 or d.df.ndim != 0 or K > MAX_K:
        raise _Unsupported(
            f"{type(d).__name__} with a batched parameter or K = {K} > {MAX_K}"
        )

    def params(dtype):
        C, w, const = d.pd_terms(dtype)
        return torch.cat([C.reshape(-1), w.reshape(1), const.reshape(1)])

    return _Entry(row0, K * (K + 1) // 2, loop=f"pd_{d.mode}", params=params)


def _plan_with_reason(u):
    """(entries covering every linked row, None), or (None, the leaf that
    has neither a slab nor a loop form)."""
    from .core import IIDUnconstrainer, LeafUnconstrainer, TreeUnconstrainer

    entries = []

    def visit(node, row0):
        if isinstance(node, TreeUnconstrainer):
            for c, (s, _) in zip(node.children, node.linked_offsets):
                visit(c, row0 + s)
        elif isinstance(node, IIDUnconstrainer):
            inner = node.inner
            if inner.event_shape == () and inner.linked_shape == ():
                entries.append(_scalar_entry(inner.dist, inner.link, node.n, row0))
            else:
                e0 = _leaf_entry(inner, row0)
                per = inner.linked_vec_length
                entries.extend(
                    dataclasses.replace(e0, row0=row0 + i * per) for i in range(node.n)
                )
        elif isinstance(node, LeafUnconstrainer):
            entries.append(_leaf_entry(node, row0))
        else:
            raise _Unsupported(type(node).__name__)

    try:
        visit(u, 0)
    except _Unsupported as e:
        return None, str(e)
    return entries, None


def _plan(u):
    """List of `_Entry` covering every linked row, or None if any leaf has
    neither a slab nor a loop form."""
    return _plan_with_reason(u)[0]
