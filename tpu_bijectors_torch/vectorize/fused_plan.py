"""The plan of the fused whole-model evaluation, PyTorch counterpart of
`tpu_bijectors/vectorize/fused_plan.py`: `_plan(u)` maps every leaf of an
unconstrainer tree onto a SLAB entry (per-row coefficients of the closed
form in fused_base.py) or a LOOP entry (a block of rows with its own
parameters, evaluated by a loop body in the kernel), or returns None when
a leaf has neither.

Slab forms ported: every scalar family of `dists/univariate.py` under its
registry link (the identity for the real-line families, the telescoped
densities of the log, logit and shifted-log links), alone, as IID blocks
or with per-element parameters (arraydist); MvNormalDiag and MvLogNormal
(its telescoped density), a row each; the telescoped Dirichlet; the LKJ
and LKJCholesky weighted logcosh. A transformed distribution takes its
base's rows; the copies of an IID block of a structured leaf are
shifted-row copies of its entry (loop copies share one parameter block). Loop forms ported, K <= 16
(MAX_K): the PD entry of Wishart (`pd_dot`) and InverseWishart
(`pd_solve`, `fused_emit.py::_emit_pd`); the Gaussian quadratic form of
MvNormalTril (`gauss_lower`) and MvNormalCanon (`gauss_upper`,
`_emit_gauss_quad`); the t form of MvStudentT (`mvt`, `_emit_mvt`). A
leaf with none of these takes a traced entry where its linked density
traces and admits (`fused_traced.py`, as `fused_plan.py:55, 306, 569` of
the JAX package): Truncated and every scalar family with no slab form
(`_traced_scalar_entry`), any other vector leaf of linked length 2-16
(`_traced_vector_entry`). Every other leaf, and a loop family beyond
K = 16, raises `_Unsupported` naming it. `_plan_with_reason` is memoised
per unconstrainer: a traced entry's trace is paid once.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from ..bijectors.base import Identity
from ..bijectors.corr import VecCholeskyBijector, VecCorrBijector
from ..bijectors.pd import PDVecBijector
from ..bijectors.simplex import SimplexBijector
from ..dists import matrix as mx
from ..dists import multivariate as mv
from ..dists import univariate as uv
from ..dists.multivariate import Dirichlet
from ..kernels.pd import MAX_K
from ..utils import _triu_index_arrays
from .fused_base import LOG2, LOG2PI, LOGPI, _Entry, _Unsupported
from .fused_traced import _traced_scalar_entry, _traced_vector_entry


def _scalar_entry(dist, link, n, row0):
    """Slab coefficients of a scalar family over n rows (`fused_plan.py:
    43-307` of the JAX package); they encode the composed path's math (the
    family's telescoped hook, or its logpdf under the identity link)
    exactly, up to float reassociation. Parameters are scalars or
    per-element (n,) tensors (arraydist), which the per-row coefficient
    columns absorb. The normalisers are formed in the state's dtype."""
    d = dist
    t = type(d)
    if t is uv.Truncated:
        return _traced_scalar_entry(d, link, n, row0)
    ident = type(link) is Identity

    def guard(ok, *params):
        if not ok:
            raise _Unsupported(f"{t.__name__} with link {type(link).__name__}")
        for p in params:
            if tuple(p.shape) not in ((), (n,)):
                raise _Unsupported(
                    f"{t.__name__} with a parameter of shape {tuple(p.shape)} over {n} rows"
                )

    def mk(fn):
        dev = getattr(d, d._params[0]).device

        def slab(dtype):
            return {k: torch.broadcast_to(torch.as_tensor(v, dtype=dtype, device=dev), (n,))
                    for k, v in fn(dtype).items()}

        return _Entry(row0, n, slab)

    def p(name, dtype):
        return getattr(d, name).to(dtype)

    # --- real line (identity link: the linked density is logpdf) ---
    if t is uv.Normal:
        guard(ident, d.loc, d.scale)

        def cf(dtype):
            sig = p("scale", dtype)
            inv_s = 1.0 / sig
            return {"m": p("loc", dtype), "cq": -0.5 * inv_s * inv_s,
                    "c0": -0.5 * LOG2PI - torch.log(sig)}

        return mk(cf)
    if t is uv.StudentT:
        guard(ident, d.df, d.loc, d.scale)

        def cf(dtype):
            v = p("df", dtype)
            sig = p("scale", dtype)
            lognorm = (torch.lgamma(0.5 * (v + 1.0)) - torch.lgamma(0.5 * v)
                       - 0.5 * (torch.log(v) + LOGPI))
            return {"m": p("loc", dtype), "c6": -0.5 * (v + 1.0),
                    "la": (1.0 / sig) / torch.sqrt(v), "c0": lognorm - torch.log(sig)}

        return mk(cf)
    if t is uv.Cauchy:
        guard(ident, d.loc, d.scale)

        def cf(dtype):
            sig = p("scale", dtype)
            return {"m": p("loc", dtype), "c6": -1.0, "la": 1.0 / sig,
                    "c0": -LOGPI - torch.log(sig)}

        return mk(cf)
    if t is uv.Laplace:
        guard(ident, d.loc, d.scale)

        def cf(dtype):
            sig = p("scale", dtype)
            inv_s = 1.0 / sig
            return {"m": p("loc", dtype), "c3p": -inv_s, "c3n": -inv_s,
                    "c0": -LOG2 - torch.log(sig)}

        return mk(cf)
    if t is uv.Logistic:
        guard(ident, d.loc, d.scale)

        def cf(dtype):
            # -z - 2 sp(-z) == -(|z| + 2 sp(-|z|)) by sp(x) = max(x, 0) + sp(-|x|)
            sig = p("scale", dtype)
            inv_s = 1.0 / sig
            return {"m": p("loc", dtype), "c3p": -inv_s, "c3n": -inv_s, "c4": -2.0,
                    "sa": -inv_s, "c0": -torch.log(sig)}

        return mk(cf)
    if t is uv.Gumbel:
        guard(ident, d.loc, d.scale)

        def cf(dtype):
            sig = p("scale", dtype)
            inv_s = 1.0 / sig
            mi = p("loc", dtype) * inv_s
            return {"c1": -inv_s, "c5": -1.0, "ea": -inv_s, "eb": mi,
                    "c0": mi - torch.log(sig)}

        return mk(cf)

    # --- positive half-line (log link, the telescoped hooks) ---
    log_link = uv._is_log_link(link)
    if t is uv.LogNormal:
        guard(log_link, d.mu, d.sigma)

        def cf(dtype):
            sig = p("sigma", dtype)
            inv_s = 1.0 / sig
            return {"m": p("mu", dtype), "cq": -0.5 * inv_s * inv_s,
                    "c0": -0.5 * LOG2PI - torch.log(sig)}

        return mk(cf)
    if t is uv.Gamma:
        guard(log_link, d.concentration, d.rate)

        def cf(dtype):
            a, r = p("concentration", dtype), p("rate", dtype)
            return {"c1": a, "c5": -r, "ea": 1.0, "c0": a * torch.log(r) - torch.lgamma(a)}

        return mk(cf)
    if t is uv.Exponential:
        guard(log_link, d.rate)

        def cf(dtype):
            r = p("rate", dtype)
            return {"c1": 1.0, "c5": -r, "ea": 1.0, "c0": torch.log(r)}

        return mk(cf)
    if t is uv.InverseGamma:
        guard(log_link, d.concentration, d.scale)

        def cf(dtype):
            a, b = p("concentration", dtype), p("scale", dtype)
            return {"c1": -a, "c5": -b, "ea": -1.0, "c0": a * torch.log(b) - torch.lgamma(a)}

        return mk(cf)
    if t is uv.HalfNormal:
        guard(log_link, d.scale)

        def cf(dtype):
            ls = torch.log(p("scale", dtype))
            return {"c1": 1.0, "c5": -0.5, "ea": 2.0, "eb": -2.0 * ls,
                    "c0": (LOG2 - 0.5 * LOG2PI) - ls}

        return mk(cf)
    if t is uv.HalfCauchy:
        guard(log_link, d.scale)

        def cf(dtype):
            # const + v - sp(2(v - ls)), the softplus folded into the U form
            ls = torch.log(p("scale", dtype))
            return {"m": ls, "c1": 1.0, "c3p": -2.0, "c4": -1.0, "sa": -2.0,
                    "c0": (LOG2 - LOGPI) - ls}

        return mk(cf)
    if t is uv.Weibull:
        guard(log_link, d.concentration, d.scale)

        def cf(dtype):
            k = p("concentration", dtype)
            c1_ = k * torch.log(p("scale", dtype))
            return {"c1": k, "c5": -1.0, "ea": k, "eb": -c1_, "c0": torch.log(k) - c1_}

        return mk(cf)
    if t is uv.Chi:
        guard(log_link, d.df)

        def cf(dtype):
            df = p("df", dtype)
            k2 = 0.5 * df
            return {"c1": df, "c5": -0.5, "ea": 2.0,
                    "c0": -(k2 - 1.0) * LOG2 - torch.lgamma(k2)}

        return mk(cf)
    if t is uv.Rayleigh:
        guard(log_link, d.scale)

        def cf(dtype):
            ls = torch.log(p("scale", dtype))
            return {"c1": 2.0, "c5": -0.5, "ea": 2.0, "eb": -2.0 * ls, "c0": -2.0 * ls}

        return mk(cf)
    if t is uv.Frechet:
        guard(log_link, d.shape_, d.scale)

        def cf(dtype):
            a = p("shape_", dtype)
            als = a * torch.log(p("scale", dtype))
            return {"c1": -a, "c5": -1.0, "ea": -a, "eb": als, "c0": torch.log(a) + als}

        return mk(cf)

    # --- unit interval and (low, high) (logit link, the telescoped hooks) ---
    if t is uv.Beta:
        guard(uv._is_interval_logit_link(link, 0.0, 1.0), d.a, d.b)

        def cf(dtype):
            # -a sp(-v) - b sp(v) == -(b 1[v>0] + a 1[v<0])|v| - (a+b) sp(-|v|)
            a, b = p("a", dtype), p("b", dtype)
            return {"c3p": -b, "c3n": -a, "c4": -(a + b), "sa": -1.0,
                    "c0": -(torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b))}

        return mk(cf)
    if t is uv.LogitNormal:
        guard(uv._is_interval_logit_link(link, 0.0, 1.0), d.mu, d.sigma)

        def cf(dtype):
            sig = p("sigma", dtype)
            inv_s = 1.0 / sig
            return {"m": p("mu", dtype), "cq": -0.5 * inv_s * inv_s,
                    "c0": -0.5 * LOG2PI - torch.log(sig)}

        return mk(cf)
    if t is uv.Uniform:
        guard(d.low.ndim == 0 and d.high.ndim == 0
              and uv._is_interval_logit_link(link, d.low, d.high), d.low, d.high)

        def cf(dtype):
            # -|v| - 2 sp(-|v|): parameter-free
            return {"c3p": -1.0, "c3n": -1.0, "c4": -2.0, "sa": -1.0}

        return mk(cf)

    # --- lower-bounded (shifted-log link, the telescoped hooks) ---
    if t is uv.Pareto:
        guard(d.scale.ndim == 0 and uv._is_shifted_log_link(link, d.scale), d.alpha, d.scale)

        def cf(dtype):
            # log a - lm + v - (a+1) sp(v - lm), the softplus in the U form
            a = p("alpha", dtype)
            lm = torch.log(p("scale", dtype))
            return {"m": lm, "c1": 1.0, "c3p": -(a + 1.0), "c4": -(a + 1.0), "sa": -1.0,
                    "c0": torch.log(a) - lm}

        return mk(cf)
    if t is uv.Levy:
        guard(d.mu.ndim == 0 and uv._is_shifted_log_link(link, d.mu), d.mu, d.sigma)

        def cf(dtype):
            s = p("sigma", dtype)
            return {"c1": -0.5, "c5": -0.5 * s, "ea": -1.0, "c0": 0.5 * (torch.log(s) - LOG2PI)}

        return mk(cf)
    # no slab form: the generic traced entry
    return _traced_scalar_entry(d, link, n, row0)


def _lkj_weights(K, eta, chol=False):
    """Per-slot weight w_s with lp = -sum_s w_s logcosh(y_s) + const: the
    closed-form logJ coefficient (K - i for the vec-corr link,
    corr.jl:474-483; j - i + 1 for the Cholesky link, corr.jl:485-501) plus
    the density's column weight (2(eta - 1); LKJCholesky's
    2 eta - 2 + K - (j + 1) on column j)."""
    rows, cols = _triu_index_arrays(K, 1)
    like = dict(dtype=eta.dtype, device=eta.device)
    if chol:
        return (torch.as_tensor(cols - rows + 1, **like)
                + 2.0 * eta - 2.0 + K - (torch.as_tensor(cols, **like) + 1.0))
    return torch.as_tensor(K - rows, **like) + 2.0 * (eta - 1.0)


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
    if ((t is mx.LKJ and type(b) is VecCorrBijector)
            or (t is mx.LKJCholesky and type(b) is VecCholeskyBijector)) and d.eta.ndim == 0:
        # the whole LKJ contribution telescopes to one weighted logcosh sum
        # over the packed slots: logcosh(y) = |y| + sp(-2|y|) - log 2 maps
        # onto (c3, c4/sa, c0); d lp/d y_s = -w_s tanh(y_s) falls out of the
        # same coefficients
        K = int(d.dim)
        P = K * (K - 1) // 2
        chol = t is mx.LKJCholesky

        def slab(dtype, d=d, K=K, P=P):
            eta = d.eta.to(dtype)
            w = _lkj_weights(K, eta, chol)
            const = -mx._lkj_log_normalizer(K, eta)
            e0 = torch.zeros(P, dtype=dtype, device=eta.device)
            e0[0] = 1.0
            return {"c3p": -w, "c3n": -w, "c4": -w,
                    "sa": torch.full_like(w, -2.0),
                    "c0": w * LOG2 + const * e0}

        return _Entry(row0, P, slab)
    if t in (mx.Wishart, mx.InverseWishart) and type(b) is PDVecBijector:
        return _pd_entry(d, row0)
    if t in (mv.MvNormalDiag, mv.MvLogNormal):
        return _mvdiag_entry(d, b, row0)
    if t in (mv.MvNormalTril, mv.MvNormalCanon, mv.MvStudentT) and mv._is_vector_link(
        b, mv._is_identity
    ):
        return _quad_entry(d, row0)
    # no hand-written form: the generic traced vector entry
    return _traced_vector_entry(leaf, row0)


def _mvdiag_entry(d, b, row0):
    """MvNormalDiag (identity link) and MvLogNormal (log link, telescoped
    to the base normal's density of v) as one slab row a coordinate
    (`fused_plan.py:328-348` of the JAX package)."""
    ok = mv._is_identity if type(d) is mv.MvNormalDiag else uv._is_log_link
    if not mv._is_vector_link(b, ok) or d.loc.ndim != 1 or d.scale_diag.ndim > 1:
        raise _Unsupported(f"{type(d).__name__} with a batched parameter or link "
                           f"{type(b).__name__}")
    K = int(d.loc.shape[-1])

    def slab(dtype, d=d, K=K):
        sig = torch.broadcast_to(d.scale_diag.to(dtype), (K,))
        inv_s = 1.0 / sig
        return {"m": d.loc.to(dtype), "cq": -0.5 * inv_s * inv_s,
                "c0": -0.5 * LOG2PI - torch.log(sig)}

    return _Entry(row0, K, slab)


def _quad_entry(d, row0):
    """The dense Gaussian and t loop entries (`fused_plan.py:349-427` of the
    JAX package), with C formed on the host: MvNormalTril C = L^-1 (lower),
    lp = -||C (v - mu)||^2 / 2 - sum log diag L - K/2 log 2pi;
    MvNormalCanon C = L' with L = chol(J) (upper), mu = J^-1 h, + sum log
    diag L; MvStudentT C = L^-1 with its df and normaliser."""
    t = type(d)
    canon = t is mv.MvNormalCanon
    loc = d.h if canon else d.loc
    mat = d.prec if canon else d.scale_tril
    K = int(loc.shape[-1])
    if loc.ndim != 1 or mat.ndim != 2 or (t is mv.MvStudentT and d.df.ndim != 0):
        raise _Unsupported(f"{t.__name__} with a batched parameter")
    if K > MAX_K:
        raise _Unsupported(f"{t.__name__} with K = {K} > {MAX_K}")

    def params(dtype, d=d, K=K):
        if canon:
            L, mu = d.chol_and_mean(dtype)
            const = -0.5 * K * LOG2PI + mv._half_logdet(L)
            return torch.cat([L.T.reshape(-1), mu, const.reshape(1)])
        L = torch.tril(d.scale_tril.to(dtype))
        eye = torch.eye(K, dtype=dtype, device=L.device)
        C = torch.linalg.solve_triangular(L, eye, upper=False)
        if t is mv.MvNormalTril:
            const = -0.5 * K * LOG2PI - mv._half_logdet(L)
            return torch.cat([C.reshape(-1), d.loc.to(dtype), const.reshape(1)])
        v = d.df.to(dtype)
        const = (torch.lgamma(0.5 * (v + K)) - torch.lgamma(0.5 * v)
                 - 0.5 * K * (torch.log(v) + LOGPI) - mv._half_logdet(L))
        return torch.cat([C.reshape(-1), d.loc.to(dtype), v.reshape(1), const.reshape(1)])

    kind = "gauss_upper" if canon else ("mvt" if t is mv.MvStudentT else "gauss_lower")
    return _Entry(row0, K, loop=kind, params=params, k=K)


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

    return _Entry(row0, K * (K + 1) // 2, loop=f"pd_{d.mode}", params=params, k=K)


# unconstrainer -> (plan or None, reason); the unconstrainers hash by
# identity (eq=False), and an entry goes with its unconstrainer
_PLAN_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _plan_with_reason(u):
    """(entries covering every linked row, None), or (None, the leaf that
    has neither a slab nor a loop form). Memoised per unconstrainer."""
    if u not in _PLAN_CACHE:
        _PLAN_CACHE[u] = _plan_uncached(u)
    return _PLAN_CACHE[u]


def _plan_uncached(u):
    from .core import (
        IIDUnconstrainer,
        LeafUnconstrainer,
        TransformedUnconstrainer,
        TreeUnconstrainer,
    )

    entries = []

    def visit(node, row0):
        if isinstance(node, TreeUnconstrainer):
            for c, (s, _) in zip(node.children, node.linked_offsets):
                visit(c, row0 + s)
        elif isinstance(node, TransformedUnconstrainer):
            # the linked density telescopes to the base's: the same rows
            visit(node.base, row0)
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
