"""Vectorization layer, PyTorch counterpart of `tpu_bijectors/vectorize/core.py`
(reference src/vector/): sample pytree <-> flat unconstrained vector.

  u = unconstrain(d, device=...)
  u.vec_length / u.linked_vec_length      static ints (no sampling)
  u.to_vec(x) / u.from_vec(v)             shape ravel, logJ == 0
  u.to_linked_vec(x) -> (v, logdet)       unconstrain + ravel
  u.from_linked_vec(v) -> (x, logdet)     the sampler's inverse
  u.from_linked_vec_with_logpdf(v)        (x, logpdf(d, x) + logdetJ): the
                                          constrained sample and its linked
                                          density in one pass
  u.linked_logdensity(v)                  logpdf(d, x) + logdetJ on (B, dim)
  u.linked_logdensity_t(vT)               the same on the transposed (dim, B)
                                          state; (B,) out
  u.optic_vec() / u.linked_optic_vec()    each slot's element of the sample
                                          (`Optic`; None for a linked slot
                                          that several elements set: the
                                          entangled links)

Leaves (`LeafUnconstrainer`), IID blocks of one leaf (`IIDUnconstrainer`,
also the per-element parameters of `arraydist`), tuple and named products
(`TreeUnconstrainer`) and transformed distributions
(`TransformedUnconstrainer`, whose linked density is its base's).
`UnconstrainerBijector` exposes an Unconstrainer as a Bijector, and the
module-level functions (`vec_length`, `to_vec`, ...) build the
Unconstrainer of a distribution and hand back the one quantity.

Offsets are static, so a batch of states is one (B, dim) array. On the
batch-major layout each leaf runs its own link: on the card the simplex,
LKJ and Wishart-family leaves launch their kernels (kernels/simplex.py,
kernels/lkj.py, kernels/pd.py), the scalar leaves are elementwise torch
ops. On the transposed layout the
whole model runs as the fused slab evaluation (`fused_kernel.try_mega`):
one CUDA kernel on the card (slab rows and the loop entries of the Wishart
families and the dense Gaussian and t families), its plain PyTorch
version for a CPU tensor.
`_linked_logdensity_t_children` is the composed per-leaf path, the
reference the fused evaluation is held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bijectors.base import Bijector
from ..dists.base import Distribution
from ..dists.product import ElementwiseProduct, IIDProduct, NamedProduct, Product
from ..registry import bijector
from ..transformed import TransformedDistribution
from ..utils import _triu_index_arrays, resolve_device, tril_to_vec, vec_to_tril


def _shape_len(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _ravel_event(x, event_shape):
    batch = x.shape[: x.ndim - len(event_shape)]
    return x.reshape(tuple(batch) + (_shape_len(event_shape),))


def _unravel_event(v, event_shape):
    return v.reshape(tuple(v.shape[:-1]) + tuple(int(s) for s in event_shape))


@dataclass(frozen=True)
class Optic:
    """Where one slot of a flat vector lives in the sample (the reference's
    optics, src/vector/interface.jl:105-184): `path` walks the product
    structure (dict keys, tuple positions, IID indices), `index` is the
    index into the leaf's array (() for a scalar-event leaf). `get(x)`
    reads the element; equality is structural."""

    path: tuple = ()
    index: tuple = ()

    def get(self, x):
        for k in self.path:
            x = x[k]
        return x[self.index] if self.index != () else x

    def prefix(self, key) -> "Optic":
        return Optic((key,) + self.path, self.index)

    def __repr__(self):
        p = "".join(".%s" % k if isinstance(k, str) else "[%d]" % k for k in self.path)
        i = "[%s]" % ", ".join(map(str, self.index)) if self.index else ""
        return "Optic(_%s%s)" % (p, i)


def _prefix_optics(optics, key):
    return [None if o is None else o.prefix(key) for o in optics]


def _ravel_optics(shape):
    """The optics of a C-order ravel of an array of `shape`."""
    shape = tuple(int(s) for s in shape)
    if shape == ():
        return [Optic((), ())]
    return [Optic((), tuple(int(i) for i in np.unravel_index(k, shape)))
            for k in range(_shape_len(shape))]


class Unconstrainer:
    """Abstract; see the module docstring."""

    vec_length: int
    linked_vec_length: int

    def to_vec(self, x):
        raise NotImplementedError

    def from_vec(self, v):
        raise NotImplementedError

    def optic_vec(self):
        raise NotImplementedError

    def linked_optic_vec(self):
        raise NotImplementedError

    def to_linked_vec(self, x):
        raise NotImplementedError

    def from_linked_vec(self, v):
        raise NotImplementedError

    def from_linked_vec_with_logpdf(self, v):
        raise NotImplementedError

    def linked_logdensity(self, v):
        raise NotImplementedError

    def _linked_logdensity_t_children(self, vT):
        raise NotImplementedError

    def linked_logdensity_t(self, vT):
        """linked_logdensity on the transposed (dim, B) layout, (B,) out:
        the fused slab evaluation where the model has one. A CUDA tensor
        always goes through the kernel (or raises); a CPU tensor takes the
        composed per-leaf path only where the model has no fused plan or
        the kernels are switched off."""
        from .fused_kernel import try_mega

        out = try_mega(self, vT)
        if out is not None:
            return out
        return self._linked_logdensity_t_children(vT)


@dataclass(frozen=True, eq=False)
class LeafUnconstrainer(Unconstrainer):
    """Any single distribution with a registry bijector.

    `chol_pack`: a Cholesky-factor event ravels as its packed triangle
    (n(n+1)/2 slots, reference src/vector/cholesky/cholesky.jl:11-68), not
    the full matrix. `entangled`: a linked slot depends on several
    elements (simplex, PD, correlation, ordered links), so the linked
    optics are None (interface.jl:168-184)."""

    dist: Distribution
    link: Bijector
    event_shape: tuple
    linked_shape: tuple
    chol_pack: bool = False
    entangled: bool = False

    @property
    def vec_length(self):  # type: ignore[override]
        if self.chol_pack:
            n = int(self.event_shape[-1])
            return n * (n + 1) // 2
        return _shape_len(self.event_shape)

    @property
    def linked_vec_length(self):  # type: ignore[override]
        return _shape_len(self.linked_shape)

    def _lower(self, x):
        return x if getattr(self.dist, "mode", "L") == "L" else x.transpose(-1, -2)

    def to_vec(self, x):
        if self.chol_pack:
            return tril_to_vec(self._lower(x))
        return _ravel_event(x, self.event_shape)

    def from_vec(self, v):
        if self.chol_pack:
            return self._lower(vec_to_tril(v))
        return _unravel_event(v, self.event_shape)

    def optic_vec(self):
        """C-order indices of a plain leaf's elements (matrix events
        included), the packed triangle's of a Cholesky-factor leaf."""
        if self.chol_pack:
            rows, cols = _triu_index_arrays(int(self.event_shape[-1]), 0)
            if getattr(self.dist, "mode", "L") == "L":
                # tril_to_vec packs the transpose: slot k is x[cols[k], rows[k]]
                return [Optic((), (int(c), int(r))) for r, c in zip(rows, cols)]
            return [Optic((), (int(r), int(c))) for r, c in zip(rows, cols)]
        return _ravel_optics(self.event_shape)

    def linked_optic_vec(self):
        """The optic of the element that alone sets each linked slot, or
        None where the link entangles them. Every registry link that is
        not entangled acts elementwise in the C-order ravel."""
        if self.entangled or self.linked_vec_length != self.vec_length:
            return [None] * self.linked_vec_length
        return self.optic_vec()

    def _extra_dims(self):
        return len(self.event_shape) - int(self.link.event_ndims_in)

    def _sum_extra(self, ld):
        """Sum a link's log-det over the event dims beyond the link's own."""
        extra = self._extra_dims()
        return torch.sum(ld, dim=tuple(range(-extra, 0))) if extra > 0 else ld

    def to_linked_vec(self, x):
        y, ld = self.link.forward_and_log_det(x)
        return _ravel_event(y, self.linked_shape), self._sum_extra(ld)

    def from_linked_vec(self, v):
        x, ld = self.link.inverse_and_log_det(_unravel_event(v, self.linked_shape))
        return x, self._sum_extra(ld)

    def from_linked_vec_with_logpdf(self, v):
        """(x, logpdf(x) + logdetJ): a distribution's composed hook where it
        has one (the Dirichlet's fuses the inverse, its log-det and the
        data term in one kernel), else the factor the inverse link computes
        anyway (LKJ: log diag W; Wishart families: the lower factor L; no
        re-decomposition of X), else the generic composition."""
        b, d = self.link, self.dist
        y = _unravel_event(v, self.linked_shape)
        hook = getattr(d, "fused_linked_logdensity", None)
        if hook is not None:
            out = hook(b, y)
            if out is not None:
                return out
        if hasattr(b, "inverse_and_log_det_with_factor") and hasattr(
            d, "logpdf_from_factor"
        ):
            x, ld, factor = b.inverse_and_log_det_with_factor(y)
            return x, d.logpdf_from_factor(factor, x) + self._sum_extra(ld)
        x, ld = self.from_linked_vec(v)
        return x, d.logpdf(x) + ld

    def linked_logdensity(self, v):
        b, d = self.link, self.dist
        hook = getattr(d, "fused_linked_logdensity", None)
        if hook is not None:
            out = hook(b, _unravel_event(v, self.linked_shape), want_x=False)
            if out is not None:
                return out[1]
        if hasattr(b, "inverse_log_det_and_factor_only") and hasattr(
            d, "logpdf_from_factor"
        ):
            ld, factor = b.inverse_log_det_and_factor_only(
                _unravel_event(v, self.linked_shape)
            )
            return d.logpdf_from_factor(factor) + self._sum_extra(ld)
        return self.from_linked_vec_with_logpdf(v)[1]

    def _linked_logdensity_t_children(self, vT):
        b, d = self.link, self.dist
        if len(self.linked_shape) == 1:
            # the (P, B) block read in place: the Wishart families' PD
            # log-density kernel, or the LKJ log-det kernel
            hook = getattr(d, "fused_linked_logdensity_t", None)
            if hook is not None:
                out = hook(b, vT)
                if out is not None:
                    return out
            if hasattr(b, "inverse_log_det_and_factor_only_t") and hasattr(
                d, "logpdf_from_factor"
            ):
                ld, factor = b.inverse_log_det_and_factor_only_t(vT)
                return d.logpdf_from_factor(factor) + ld
        if self.linked_shape == () and self.event_shape == ():
            # scalar leaf: link and density are elementwise, the (1, B) row
            # works in place (telescoped hooks like LogNormal's still fire)
            return self.linked_logdensity(vT[0][..., None])
        return self.linked_logdensity(vT.transpose(0, 1))


@dataclass(frozen=True, eq=False)
class IIDUnconstrainer(Unconstrainer):
    """Homogeneous block: ONE bijector over a batched leading axis."""

    inner: LeafUnconstrainer
    n: int

    @property
    def vec_length(self):  # type: ignore[override]
        return self.n * self.inner.vec_length

    @property
    def linked_vec_length(self):  # type: ignore[override]
        return self.n * self.inner.linked_vec_length

    def to_vec(self, x):
        v = self.inner.to_vec(x)  # (..., n, inner length)
        return v.reshape(tuple(v.shape[:-2]) + (self.vec_length,))

    def from_vec(self, v):
        return self.inner.from_vec(
            v.reshape(tuple(v.shape[:-1]) + (self.n, self.inner.vec_length)))

    def optic_vec(self):
        inner = self.inner.optic_vec()
        return [o for i in range(self.n) for o in _prefix_optics(inner, i)]

    def linked_optic_vec(self):
        inner = self.inner.linked_optic_vec()
        return [o for i in range(self.n) for o in _prefix_optics(inner, i)]

    def _split(self, v):
        return v.reshape(tuple(v.shape[:-1]) + (self.n, self.inner.linked_vec_length))

    def to_linked_vec(self, x):
        y, ld = self.inner.to_linked_vec(x)  # y: (..., n, L_i); ld: (..., n)
        return y.reshape(tuple(y.shape[:-2]) + (self.linked_vec_length,)), ld.sum(-1)

    def from_linked_vec(self, v):
        x, ld = self.inner.from_linked_vec(self._split(v))
        return x, ld.sum(-1)

    def from_linked_vec_with_logpdf(self, v):
        x, lp = self.inner.from_linked_vec_with_logpdf(self._split(v))
        return x, lp.sum(-1)

    def linked_logdensity(self, v):
        return self.inner.linked_logdensity(self._split(v)).sum(-1)

    def _linked_logdensity_t_children(self, vT):
        inner = self.inner
        if (
            inner.linked_shape == ()
            and inner.event_shape == ()
            and tuple(inner.dist.batch_shape) == ()
        ):
            # scalar inner: vT is (n, B) and everything is elementwise —
            # evaluate in place and reduce the block axis
            return inner.linked_logdensity(vT[..., None]).sum(0)
        return self.linked_logdensity(vT.transpose(0, 1))


@dataclass(frozen=True, eq=False)
class TreeUnconstrainer(Unconstrainer):
    """Tuple or named product with static offsets (reference
    ProductVecTransform, src/vector/product/product.jl:20-320): `names`
    None makes a tuple-valued sample (`Product`), else a dict."""

    children: tuple
    offsets: tuple  # (start, length) of each child in vec space
    linked_offsets: tuple
    names: tuple = None

    @classmethod
    def build(cls, children, names=None):
        ofs, lofs, o, lo = [], [], 0, 0
        for c in children:
            ofs.append((o, c.vec_length))
            lofs.append((lo, c.linked_vec_length))
            o += c.vec_length
            lo += c.linked_vec_length
        return cls(tuple(children), tuple(ofs), tuple(lofs),
                   None if names is None else tuple(names))

    @property
    def vec_length(self):  # type: ignore[override]
        return sum(n for _, n in self.offsets)

    @property
    def linked_vec_length(self):  # type: ignore[override]
        return sum(n for _, n in self.linked_offsets)

    def _keys(self):
        return range(len(self.children)) if self.names is None else self.names

    def _parts(self, x):
        return [x[k] for k in self._keys()]

    def _rebuild(self, parts):
        return tuple(parts) if self.names is None else dict(zip(self.names, parts))

    def to_vec(self, x):
        return torch.cat([c.to_vec(xi) for c, xi in zip(self.children, self._parts(x))], dim=-1)

    def from_vec(self, v):
        return self._rebuild(
            [c.from_vec(v[..., s : s + n]) for c, (s, n) in zip(self.children, self.offsets)])

    def optic_vec(self):
        return [o for c, k in zip(self.children, self._keys())
                for o in _prefix_optics(c.optic_vec(), k)]

    def linked_optic_vec(self):
        return [o for c, k in zip(self.children, self._keys())
                for o in _prefix_optics(c.linked_optic_vec(), k)]

    def to_linked_vec(self, x):
        vs, ld = [], None
        for c, xi in zip(self.children, self._parts(x)):
            vi, ldi = c.to_linked_vec(xi)
            vs.append(vi)
            ld = ldi if ld is None else ld + ldi
        return torch.cat(vs, dim=-1), ld

    def from_linked_vec(self, v):
        parts, ld = [], None
        for c, (s, n) in zip(self.children, self.linked_offsets):
            xi, ldi = c.from_linked_vec(v[..., s : s + n])
            parts.append(xi)
            ld = ldi if ld is None else ld + ldi
        return self._rebuild(parts), ld

    def from_linked_vec_with_logpdf(self, v):
        parts, acc = [], None
        for c, (s, n) in zip(self.children, self.linked_offsets):
            xi, a = c.from_linked_vec_with_logpdf(v[..., s : s + n])
            parts.append(xi)
            acc = a if acc is None else acc + a
        return self._rebuild(parts), acc

    def linked_logdensity(self, v):
        acc = None
        for c, (s, n) in zip(self.children, self.linked_offsets):
            a = c.linked_logdensity(v[..., s : s + n])
            acc = a if acc is None else acc + a
        return acc

    def _linked_logdensity_t_children(self, vT):
        # each child's block is a contiguous row slice
        acc = None
        for c, (s, n) in zip(self.children, self.linked_offsets):
            a = c._linked_logdensity_t_children(vT[s : s + n, :])
            acc = a if acc is None else acc + a
        return acc


@dataclass(frozen=True, eq=False)
class TransformedUnconstrainer(Unconstrainer):
    """to_linked_vec(td) = to_linked_vec(td.base) o inverse(td.transform)
    (reference src/vector/transformed.jl:4-11). The linked density
    telescopes to the base's: the transform's forward and inverse log-dets
    cancel, so no sample is formed and the transform is not evaluated."""

    base: Unconstrainer
    td: TransformedDistribution

    @property
    def vec_length(self):  # type: ignore[override]
        return _shape_len(self.td.event_shape)

    @property
    def linked_vec_length(self):  # type: ignore[override]
        return self.base.linked_vec_length

    def to_vec(self, y):
        return _ravel_event(y, self.td.event_shape)

    def from_vec(self, v):
        return _unravel_event(v, self.td.event_shape)

    def optic_vec(self):
        return _ravel_optics(self.td.event_shape)

    def linked_optic_vec(self):
        # a user transform can entangle arbitrarily (reference
        # src/vector/transformed.jl keeps no provenance either)
        return [None] * self.linked_vec_length

    def _extra_dims(self):
        return self.td.base.event_ndims - int(self.td.transform.event_ndims_in)

    def to_linked_vec(self, y):
        x, ld = self.td.transform.inverse_and_log_det(y)
        extra = self._extra_dims()
        if extra > 0:
            ld = torch.sum(ld, dim=tuple(range(-extra, 0)))
        v, ld2 = self.base.to_linked_vec(x)
        return v, ld + ld2

    def from_linked_vec(self, v):
        x, ld = self.base.from_linked_vec(v)
        y, ld2 = self.td.transform.forward_and_log_det(x)
        extra = self._extra_dims()
        if extra > 0:
            ld2 = torch.sum(ld2, dim=tuple(range(-extra, 0)))
        return y, ld + ld2

    def from_linked_vec_with_logpdf(self, v):
        x, lpld = self.base.from_linked_vec_with_logpdf(v)
        return self.td.transform.forward(x), lpld

    def linked_logdensity(self, v):
        return self.base.linked_logdensity(v)

    def _linked_logdensity_t_children(self, vT):
        return self.base._linked_logdensity_t_children(vT)


@dataclass(frozen=True, eq=False)
class UnconstrainerBijector(Bijector):
    """An Unconstrainer as a Bijector: the sample (a tensor, tuple or dict)
    -> the flat unconstrained vector (the reference's NamedStacked
    bijector, src/bijectors/named_stacked.jl, for any product)."""

    u: Unconstrainer

    event_ndims_in = 0  # the input is a sample structure, not one array
    event_ndims_out = 1

    def forward_and_log_det(self, x):
        return self.u.to_linked_vec(x)

    def inverse_and_log_det(self, v):
        return self.u.from_linked_vec(v)

    def forward_event_shape(self, shape):
        return (self.u.linked_vec_length,)


# kinds whose link couples elements (linked slot k depends on more than
# x[k]), so their linked optics are None; the ordered link's slot k is
# log(x_k - x_{k-1}), a bidiagonal Jacobian
_ENTANGLED_KINDS = {"simplex", "pd", "corr", "chol_corr", "joint_order", "ordered"}


def unconstrain(d: Distribution, *, device=None) -> Unconstrainer:
    """Build the Unconstrainer for `d` with every parameter on `device`
    (default `cuda`; raises when CUDA is absent and no device was given)."""
    return _unconstrain(d.to(resolve_device(device)))


def _unconstrain(d: Distribution) -> Unconstrainer:
    if isinstance(d, TransformedDistribution):
        return TransformedUnconstrainer(_unconstrain(d.base), d)
    if isinstance(d, IIDProduct):
        inner = _unconstrain(d.base)
        if isinstance(inner, LeafUnconstrainer):
            return IIDUnconstrainer(inner, d.n)
        # a nested IID chain of one family is one leaf with a larger event
        base = d.base
        while isinstance(base, IIDProduct):
            base = base.base
        if isinstance(_unconstrain(base), LeafUnconstrainer):
            return _leaf_unconstrain(d)
        raise NotImplementedError(
            "IIDProduct of a named-structured base has a stacked-array sample "
            "per component, not n separate samples; build a NamedProduct of "
            "explicit copies instead"
        )
    if isinstance(d, ElementwiseProduct):
        # arraydist: the inner leaf's (n,) parameters broadcast along the
        # block axis of every IIDUnconstrainer method
        return IIDUnconstrainer(_leaf_unconstrain(d.base), d.n)
    if isinstance(d, Product):
        return TreeUnconstrainer.build(tuple(_unconstrain(c) for c in d.components))
    if isinstance(d, NamedProduct):
        return TreeUnconstrainer.build(
            tuple(_unconstrain(c) for c in d.components), d.names
        )
    return _leaf_unconstrain(d)


def _leaf_unconstrain(d: Distribution) -> LeafUnconstrainer:
    b = bijector(d)
    ev = tuple(int(s) for s in d.event_shape)
    ne_in = int(b.event_ndims_in)
    if ne_in == 0:
        linked = ev
    else:
        linked = ev[: len(ev) - ne_in] + tuple(
            b.forward_event_shape(ev[len(ev) - ne_in :])
        )
    kind = d.support.kind
    return LeafUnconstrainer(d, b, ev, linked, chol_pack=(kind == "chol_corr"),
                             entangled=(kind in _ENTANGLED_KINDS))


# the module-level API of the reference's eight generic functions; each
# builds the Unconstrainer of `d` with its parameters on `device` (default
# `cuda`, as `unconstrain`)


def vec_length(d: Distribution, *, device=None) -> int:
    return unconstrain(d, device=device).vec_length


def linked_vec_length(d: Distribution, *, device=None) -> int:
    return unconstrain(d, device=device).linked_vec_length


def to_vec(d: Distribution, *, device=None):
    return unconstrain(d, device=device).to_vec


def from_vec(d: Distribution, *, device=None):
    return unconstrain(d, device=device).from_vec


def to_linked_vec(d: Distribution, *, device=None):
    return unconstrain(d, device=device).to_linked_vec


def from_linked_vec(d: Distribution, *, device=None):
    return unconstrain(d, device=device).from_linked_vec


def optic_vec(d: Distribution, *, device=None):
    return unconstrain(d, device=device).optic_vec()


def linked_optic_vec(d: Distribution, *, device=None):
    return unconstrain(d, device=device).linked_optic_vec()
