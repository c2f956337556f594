"""Vectorization layer, PyTorch counterpart of `tpu_bijectors/vectorize/core.py`
(reference src/vector/): sample pytree <-> flat unconstrained vector.

  u = unconstrain(d, device=...)
  u.linked_vec_length                     static int
  u.to_linked_vec(x) -> (v, logdet)       unconstrain + ravel
  u.from_linked_vec(v) -> (x, logdet)     the sampler's inverse
  u.from_linked_vec_with_logpdf(v)        (x, logpdf(d, x) + logdetJ): the
                                          constrained sample and its linked
                                          density in one pass
  u.linked_logdensity(v)                  logpdf(d, x) + logdetJ on (B, dim)
  u.linked_logdensity_t(vT)               the same on the transposed (dim, B)
                                          state; (B,) out

Leaves (`LeafUnconstrainer`), IID blocks of one leaf (`IIDUnconstrainer`,
also the per-element parameters of `arraydist`), named products
(`TreeUnconstrainer`) and transformed distributions
(`TransformedUnconstrainer`, whose linked density is its base's).

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

import torch

from ..bijectors.base import Bijector
from ..dists.base import Distribution
from ..dists.product import ElementwiseProduct, IIDProduct, NamedProduct
from ..registry import bijector
from ..transformed import TransformedDistribution
from ..utils import resolve_device


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


class Unconstrainer:
    """Abstract; see the module docstring."""

    linked_vec_length: int

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
    """Any single distribution with a registry bijector."""

    dist: Distribution
    link: Bijector
    event_shape: tuple
    linked_shape: tuple

    @property
    def linked_vec_length(self):  # type: ignore[override]
        return _shape_len(self.linked_shape)

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
    def linked_vec_length(self):  # type: ignore[override]
        return self.n * self.inner.linked_vec_length

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
    """Named product with static offsets (reference ProductVecTransform,
    src/vector/product/product.jl:20-320)."""

    children: tuple
    linked_offsets: tuple
    names: tuple

    @classmethod
    def build(cls, children, names):
        lofs, lo = [], 0
        for c in children:
            lofs.append((lo, c.linked_vec_length))
            lo += c.linked_vec_length
        return cls(tuple(children), tuple(lofs), tuple(names))

    @property
    def linked_vec_length(self):  # type: ignore[override]
        return sum(n for _, n in self.linked_offsets)

    def to_linked_vec(self, x):
        vs, ld = [], None
        for c, name in zip(self.children, self.names):
            vi, ldi = c.to_linked_vec(x[name])
            vs.append(vi)
            ld = ldi if ld is None else ld + ldi
        return torch.cat(vs, dim=-1), ld

    def from_linked_vec(self, v):
        parts, ld = {}, None
        for c, name, (s, n) in zip(self.children, self.names, self.linked_offsets):
            xi, ldi = c.from_linked_vec(v[..., s : s + n])
            parts[name] = xi
            ld = ldi if ld is None else ld + ldi
        return parts, ld

    def from_linked_vec_with_logpdf(self, v):
        parts, acc = {}, None
        for c, name, (s, n) in zip(self.children, self.names, self.linked_offsets):
            xi, a = c.from_linked_vec_with_logpdf(v[..., s : s + n])
            parts[name] = xi
            acc = a if acc is None else acc + a
        return parts, acc

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
    def linked_vec_length(self):  # type: ignore[override]
        return self.base.linked_vec_length

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
    return LeafUnconstrainer(d, b, ev, linked)
