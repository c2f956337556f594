"""Distribution base, PyTorch counterpart of `tpu_bijectors/dists/base.py`.

Every distribution is a frozen dataclass. Leaf families hold their
parameters as tensors on one device, chosen at construction: `cuda` unless
the caller passes `device=` (see `utils.resolve_device`). `logpdf(x)` sums
over event dims and broadcasts over leading batch dims; `support` is the
static metadata the `bijector(d)` registry dispatches on (reference
src/Bijectors.jl:268-320).

`quantile(q)` defaults to the JAX package's solver on `cdf`
(`tpu_bijectors/dists/base.py:151-213`): bracket expansion on an
unbounded side (64 steps), bisection (80) and a bracket-clipped Newton
polish (3), every trip count static, so it reads nothing back from the
device. Its derivative is the implicit-function rule of
`_ImplicitQuantile`: dx = (dq - dcdf/dtheta . dtheta) / pdf(x).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import KW_ONLY, InitVar, dataclass
from typing import ClassVar

import numpy as np
import torch

from ..utils import resolve_device


@dataclass(frozen=True)
class Support:
    """Static support descriptor: kind 'interval' (with bounds and their
    finiteness), 'real_vector', 'real_matrix', 'simplex', 'corr',
    'chol_corr', 'pd', 'discrete', 'reshaped', 'joint_order' or
    'product'."""

    kind: str = "interval"
    lower: float = -math.inf
    upper: float = math.inf
    lower_finite: bool = False
    upper_finite: bool = False


def real_line() -> Support:
    return Support("interval", -math.inf, math.inf, False, False)


def positive() -> Support:
    return Support("interval", 0.0, math.inf, True, False)


def unit_interval() -> Support:
    return Support("interval", 0.0, 1.0, True, True)


def interval(lo: float, hi: float) -> Support:
    """The finite interval (lo, hi)."""
    return Support("interval", lo, hi, True, True)


def lower_bounded(lo: float) -> Support:
    return Support("interval", lo, math.inf, True, False)


REAL_VECTOR = Support("real_vector")
SIMPLEX = Support("simplex")
CORRELATION = Support("corr")
CHOLESKY_CORRELATION = Support("chol_corr")
POSITIVE_DEFINITE = Support("pd")
DISCRETE = Support("discrete")
REAL_MATRIX = Support("real_matrix")


class Distribution:
    """Abstract distribution."""

    event_ndims: int = 0
    # each tensor leaf acts on the x it broadcasts against (a Mixture's
    # components do not: each x sees all K)
    _leafwise_cdf: bool = True

    @property
    def event_shape(self) -> tuple:
        return ()

    @property
    def batch_shape(self) -> tuple:
        return ()

    @property
    def support(self) -> Support:
        return real_line()

    def logpdf(self, x):
        raise NotImplementedError(type(self).__name__)

    def sample(self, generator, sample_shape: tuple = ()):
        """Draws of shape sample_shape + batch_shape + event_shape, every
        random number from `generator` (a `torch.Generator` on the
        parameters' device)."""
        raise NotImplementedError(type(self).__name__)

    def sample_and_logpdf(self, generator, sample_shape: tuple = ()):
        x = self.sample(generator, sample_shape)
        return x, self.logpdf(x)

    def cdf(self, x):
        raise NotImplementedError(type(self).__name__)

    def quantile(self, q):
        """The generic quantile: `_quantile_bisect`'s solve, differentiable
        by the implicit-function rule in q and in every tensor leaf of the
        distribution (a wrapper's base included). A family with a closed
        form overrides it."""
        if not isinstance(q, torch.Tensor):
            like = first_param(self)
            q = torch.as_tensor(q, dtype=like.dtype, device=like.device)
        leaves = _tensor_leaves(self)
        paths = tuple(p for p, _ in leaves)
        return _ImplicitQuantile.apply(q, (self, paths), *(v for _, v in leaves))

    def _quantile_bisect(self, q):
        """x with cdf(x) = q, no derivative: bracket expansion on an
        unbounded side (64 steps), bisection (80) and a Newton polish
        clipped to the bracket (3)."""
        s = self.support
        lo = torch.full_like(q, s.lower if s.lower_finite else -1.0)
        hi = torch.full_like(q, s.upper if s.upper_finite else 1.0)
        # an infinite side starts its expansion beyond the finite one
        if s.lower_finite and not s.upper_finite:
            hi = torch.maximum(hi, lo + 1.0)
        if s.upper_finite and not s.lower_finite:
            lo = torch.minimum(lo, hi - 1.0)
        if not (s.lower_finite and s.upper_finite):
            for _ in range(_EXPAND_STEPS):
                width = torch.clamp_min(hi - lo, 1.0)
                if not s.lower_finite:
                    lo = torch.where(self.cdf(lo) > q, lo - width, lo)
                if not s.upper_finite:
                    hi = torch.where(self.cdf(hi) < q, hi + width, hi)
        for _ in range(_BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            go_hi = self.cdf(mid) < q
            lo, hi = torch.where(go_hi, mid, lo), torch.where(go_hi, hi, mid)
        x = 0.5 * (lo + hi)
        tiny = torch.finfo(q.dtype).tiny
        for _ in range(_NEWTON_STEPS):
            pdf = torch.exp(self.logpdf(x))
            step = (self.cdf(x) - q) / torch.clamp_min(pdf, tiny)
            ok = torch.isfinite(step) & (pdf > 0)
            xn = torch.minimum(torch.maximum(x - torch.where(ok, step, 0.0), lo), hi)
            x = torch.where(torch.isfinite(xn), xn, x)
        return x

    def in_support(self, x, atol: float = 1e-8):
        """Whether x lies in the support, to within atol (the property
        sweep's check, reference src/vector/test_utils.jl:325-374)."""
        s = self.support
        n = self.event_ndims
        if s.kind == "interval":
            ok = torch.ones_like(x, dtype=torch.bool)
            if s.lower_finite:
                ok = ok & (x >= s.lower - atol)
            if s.upper_finite:
                ok = ok & (x <= s.upper + atol)
            return torch.all(ok, dim=tuple(range(-n, 0))) if n else ok
        if s.kind == "simplex":
            return (torch.abs(torch.sum(x, -1) - 1.0) < max(atol, 1e-6)) & torch.all(x >= -atol, -1)
        if s.kind in ("pd", "corr"):
            eig = torch.linalg.eigvalsh(0.5 * (x + x.transpose(-1, -2)))
            ok = torch.all(eig > -atol, -1)
            if s.kind == "corr":
                d = torch.diagonal(x, dim1=-2, dim2=-1)
                ok = ok & torch.all(torch.abs(d - 1.0) < max(atol, 1e-6), -1)
            return ok
        if s.kind == "chol_corr":
            return torch.all(torch.diagonal(x, dim1=-2, dim2=-1) > -atol, -1)
        return torch.ones(x.shape[: x.ndim - n], dtype=torch.bool, device=x.device)

    def to(self, device) -> "Distribution":
        """The same distribution with every parameter on `device`."""
        raise NotImplementedError(type(self).__name__)

    # the affine algebra (`Logistic() + 2`, `Gamma(2, 3) * -3`: the JAX
    # package's `dists/base.py:219-243`), building dists.affine.Affine

    def __add__(self, c):
        from .affine import affine

        return affine(self, loc=c)

    __radd__ = __add__

    def __sub__(self, c):
        return self + (-c)

    def __rsub__(self, c):
        return (-self) + c

    def __mul__(self, c):
        from .affine import affine

        return affine(self, scale=c)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)

    def __truediv__(self, c):
        return self * (1.0 / c)


_EXPAND_STEPS, _BISECT_STEPS, _NEWTON_STEPS = 64, 80, 3


def _tensor_leaves(dist, prefix=()):
    """(path, tensor) for every floating tensor field of `dist`, recursing
    into fields that are distributions (a Truncated's or Mixture's base):
    the leaves the JAX package's pytree flattening differentiates."""
    if not dataclasses.is_dataclass(dist):
        return []
    out = []
    for f in dataclasses.fields(dist):
        if not f.init:
            continue
        v = getattr(dist, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            out.append((prefix + (f.name,), v))
        elif isinstance(v, Distribution):
            out.extend(_tensor_leaves(v, prefix + (f.name,)))
    return out


def _with_leaves(dist, values: dict):
    """`dist` with the tensors in `values` (keyed by their
    `_tensor_leaves` path) put in, their autograd history kept."""
    own, inner = {}, {}
    for path, v in values.items():
        if len(path) == 1:
            own[path[0]] = v
        else:
            inner.setdefault(path[0], {})[path[1:]] = v
    for name, sub in inner.items():
        own[name] = _with_leaves(getattr(dist, name), sub)
    if isinstance(dist, LeafDistribution):
        return dataclasses.replace(dist, device=next(iter(own.values())).device, **own)
    return dataclasses.replace(dist, **own)


def _fd_leaf(dist, path) -> bool:
    """Whether the cdf lacks an autograd derivative in the leaf at `path`:
    its owner names it in `_cdf_fd`."""
    for name in path[:-1]:
        dist = getattr(dist, name)
    return path[-1] in getattr(dist, "_cdf_fd", ())


def _sum_to(g, shape):
    return g.sum_to_size(shape) if tuple(g.shape) != tuple(shape) else g


def _cdf_with(dist, paths, values, x):
    return _with_leaves(dist, dict(zip(paths, values))).cdf(x)


def _fd_partial(dist, x, path, v):
    """dcdf/dtheta at x (detached) for the leaf at `path` (value v, detached),
    elementwise over x's shape, by central differences at
    h = eps^(1/3) (|theta| + 1), as the JAX package takes them for betainc
    (`tpu_bijectors/dists/base.py:327-342`). Elementwise needs each entry of
    the leaf to act on the x it broadcasts to, which a Mixture's components
    do not."""
    owner = dist
    for name in path[:-1]:
        if not owner._leafwise_cdf:
            raise NotImplementedError(
                f"the quantile's central-difference partial in {'.'.join(path)}: "
                f"{type(owner).__name__} mixes its leaves across x"
            )
        owner = getattr(owner, name)
    h = float(torch.finfo(x.dtype).eps) ** (1.0 / 3.0) * (torch.abs(v) + 1.0)
    with torch.no_grad():
        fp = _with_leaves(dist, {path: v + h}).cdf(x)
        fm = _with_leaves(dist, {path: v - h}).cdf(x)
    return ((fp - fm) / (2.0 * h)).expand(x.shape)


def _cdf_jvp(dist, x, paths, params, live, tangents):
    """sum over the live leaves of dcdf/dtheta . dtheta at x (detached): by
    the double-backward trick where the cdf has the autograd derivative,
    else by `_fd_partial`. Linear in the tangents."""
    x = x.detach()
    out = torch.zeros_like(x)
    auto = []
    for i in live:
        if _fd_leaf(dist, paths[i]):
            out = out + _fd_partial(dist, x, paths[i], params[i].detach()) * tangents[i]
        else:
            auto.append(i)
    if auto:
        with torch.enable_grad():
            vals = [t.detach() for t in params]
            for i in auto:
                vals[i] = vals[i].requires_grad_(True)
            c = _cdf_with(dist, paths, vals, x)
            u = torch.zeros_like(c, requires_grad=True)
            gs = torch.autograd.grad(c, [vals[i] for i in auto], u, create_graph=True, allow_unused=True)
            pairs = [(g, tangents[i]) for g, i in zip(gs, auto) if g is not None and g.requires_grad]
            if pairs:
                (j,) = torch.autograd.grad([g for g, _ in pairs], u, [t for _, t in pairs],
                                           allow_unused=True)
                out = out + (0.0 if j is None else j.detach())
    return out


class _ImplicitQuantile(torch.autograd.Function):
    """x = quantile(q; theta) from `_quantile_bisect`, its derivative the
    implicit-function rule (the JAX package's `_generic_quantile_jvp`):
    differentiating cdf(x(q, theta); theta) = q gives

        dx = (dq - dcdf/dtheta . dtheta) / pdf(x),

    1 / pdf taken as 0 where pdf(x) = 0 (a mask on the primal alone, so
    the map stays linear in (dq, dtheta)). `params` are the distribution's
    tensor leaves, at `paths` (`_tensor_leaves`); dcdf/dtheta comes from
    autograd through the cdf, or from `_fd_partial` for a leaf in which
    torch's cdf has no derivative. The backward is built from
    differentiable ops on x re-attached to q and theta with that first
    derivative (its value exactly x), so a second derivative is taken
    through it; the central-difference partials are constants of the
    primal there."""

    @staticmethod
    def forward(ctx, q, dist_paths, *params):
        dist, ctx.paths = dist_paths
        with torch.no_grad():
            x = dist._quantile_bisect(q)
        ctx.dist = dist
        ctx.save_for_backward(x, q, *params)
        ctx.save_for_forward(x, q, *params)
        return x

    @staticmethod
    def _inv_pdf(dist, x):
        pdf = torch.exp(dist.logpdf(x))
        tiny = torch.finfo(x.dtype).tiny
        return torch.where(pdf > 0, 1.0 / torch.clamp_min(pdf, tiny), torch.zeros_like(pdf))

    @staticmethod
    def jvp(ctx, dq, _dist_paths, *dparams):
        x, q, *params = ctx.saved_tensors
        dist = ctx.dist
        live = [i for i, t in enumerate(dparams) if t is not None]
        dx = torch.zeros_like(x) if dq is None else dq.expand(x.shape).clone()
        if live:
            dx = dx - _cdf_jvp(dist, x, ctx.paths, params, live, dparams)
        with torch.no_grad():
            return dx * _ImplicitQuantile._inv_pdf(dist, x)

    @staticmethod
    def backward(ctx, gx):
        x, q, *params = ctx.saved_tensors
        dist, paths = ctx.dist, ctx.paths
        needs = ctx.needs_input_grad
        live = [i for i in range(len(params)) if needs[2 + i]]
        fd = {i: _fd_partial(dist, x.detach(), paths[i], params[i].detach())
              for i in live if _fd_leaf(dist, paths[i])}
        auto = [i for i in live if i not in fd]
        double = torch.is_grad_enabled()
        if double:
            # a double backward: x as a function of q and theta with its
            # first derivative, its value exactly x
            inv0 = _ImplicitQuantile._inv_pdf(dist, x).detach()
            delta = q - q.detach()
            for i, part in fd.items():
                delta = delta - part * (params[i] - params[i].detach())
            if auto:
                vals = [t.detach() for t in params]
                for i in auto:
                    vals[i] = params[i]
                c = _cdf_with(dist, paths, vals, x.detach())
                delta = delta - (c - c.detach())
            x = x.detach() + delta * inv0
            dist = _with_leaves(dist, dict(zip(paths, params))) if params else dist
        w = gx * _ImplicitQuantile._inv_pdf(dist, x)
        gq = _sum_to(w, q.shape) if needs[0] else None
        gparams = [None] * len(params)
        for i, part in fd.items():
            gparams[i] = _sum_to(-w * part, params[i].shape)
        if auto:
            with torch.enable_grad():
                # the direct partial dcdf/dtheta at x: through an alias of
                # each leaf, not through x's own dependence on theta
                vals = [t.detach() for t in params]
                for i in auto:
                    vals[i] = params[i].view_as(params[i]) if double else vals[i].requires_grad_(True)
                c = _cdf_with(dist, paths, vals, x if double else x.detach())
                gs = torch.autograd.grad(c, [vals[i] for i in auto], -w, create_graph=double,
                                         allow_unused=True)
            for i, g in zip(auto, gs):
                gparams[i] = torch.zeros_like(params[i]) if g is None else g
        return (gq, None, *gparams)


def _as_param(v, device, dtype):
    if isinstance(v, torch.Tensor):
        if dtype is None and not v.is_floating_point():
            dtype = torch.get_default_dtype()
        return v.to(device=device, dtype=dtype)
    # a copy: the distribution does not alias the caller's array
    return torch.tensor(
        np.asarray(v), dtype=dtype or torch.get_default_dtype(), device=device
    )


def first_param(d: Distribution):
    """The first tensor parameter of `d`, found through products, wrappers
    and a mixture's components (None where it has none): its dtype and
    device are the distribution's. A family with no tensor parameter
    (Kolmogorov, DiscreteUniform, ...) answers with its `_like`."""
    while not getattr(d, "_params", ()):
        if getattr(d, "_like", None) is not None:
            return d._like
        if hasattr(d, "components"):
            d = d.components[0] if isinstance(d.components, tuple) else d.components
        elif hasattr(d, "base"):
            d = d.base
        else:
            return None
    return getattr(d, d._params[0])


@dataclass(frozen=True)
class LeafDistribution(Distribution):
    """A family with tensor parameters (named by `_params`), converted at
    construction to tensors of `dtype` (default: a floating tensor keeps
    its own, anything else takes torch's default) on `device`. A family
    with none keeps a zero-dim `_like` tensor of that dtype and device,
    the dtype and device of its draws and of its trace."""

    _params: ClassVar[tuple] = ()
    # the parameters in which torch's cdf has no autograd derivative
    # (gammainc's a, the port's betainc's a and b): the quantile's partials
    # in them take central differences
    _cdf_fd: ClassVar[tuple] = ()
    _: KW_ONLY
    device: InitVar[object] = None
    dtype: InitVar[object] = None

    def __post_init__(self, device, dtype):
        dev = resolve_device(device)
        for name in self._params:
            object.__setattr__(self, name, _as_param(getattr(self, name), dev, dtype))
        if not self._params:
            object.__setattr__(self, "_like", torch.zeros(
                (), dtype=dtype or torch.get_default_dtype(), device=dev))

    @property
    def batch_shape(self) -> tuple:
        n = self.event_ndims
        shapes = [tuple(getattr(self, p).shape) for p in self._params]
        return tuple(torch.broadcast_shapes(*(s[: len(s) - n] for s in shapes)))

    def to(self, device):
        moved = {p: getattr(self, p).to(device) for p in self._params}
        if not self._params:
            return dataclasses.replace(self, device=device, dtype=self._like.dtype)
        return dataclasses.replace(self, device=device, **moved)


@dataclass(frozen=True)
class DiscreteDistribution(LeafDistribution):
    """A family on a discrete set: the registry's Identity link
    (reference src/transformed_distribution.jl:75-76). Its `logpdf` is the
    pmf's log."""

    @property
    def support(self):
        return DISCRETE
