"""Distribution -> bijector registry, PyTorch counterpart of
`tpu_bijectors/registry.py` (reference src/transformed_distribution.jl:40-149
and src/Bijectors.jl:249-262).

`bijector(d)` takes a rule registered for d's type (`register_bijector`;
`ordered(d)`'s OrderedDistribution registers its own link), else resolves
from the distribution's static `support`:
simplex -> SimplexBijector, corr -> VecCorrBijector, chol_corr ->
VecCholeskyBijector in the family's triangle mode (`tpu_bijectors/
registry.py:65-69`), pd -> PDVecBijector (`:61`), interval -> the
Truncated(lb, ub) branch its finite bounds select, or Identity on the
real line, real_vector and real_matrix -> elementwise Identity (`:79`),
discrete -> elementwise Identity (`:57-58`, src/transformed_distribution.jl:
75-76), reshaped -> Chain((bijector(base), Reshape)) (`:81-87`,
src/transformed_distribution.jl:144-149), joint_order ->
Chain(Invert(Ordered), Block(base link)), with a SignFlip sandwich for
a decreasing base link (`:88-109`). A
TransformedDistribution composes its wrapper away
(`Chain((bijector(base), inverse(transform)))`,
src/transformed_distribution.jl:45-48). Other support kinds are not
ported yet and raise. `link(d, x)` and `invlink(d, y)` are its forward
and inverse (src/Bijectors.jl:156, 183).
"""

from __future__ import annotations

import math

import torch

from .bijectors.base import Bijector, Block, Chain, Identity, elementwise, inverse
from .bijectors.corr import VecCholeskyBijector, VecCorrBijector
from .bijectors.ordered import OrderedBijector
from .bijectors.pd import PDVecBijector
from .bijectors.scalar import SignFlip, Truncated
from .bijectors.simplex import SimplexBijector
from .dists.base import Distribution
from .utils import _eps

_REGISTRY: dict = {}


def register_bijector(dist_type: type):
    """Register `fn(d) -> Bijector` for a distribution type (and its
    subclasses)."""

    def deco(fn):
        _REGISTRY[dist_type] = fn
        return fn

    return deco


def bijector(d: Distribution) -> Bijector:
    """The constrained -> unconstrained bijector for `d`."""
    from .transformed import TransformedDistribution

    for t in type(d).__mro__:
        if t in _REGISTRY:
            return _REGISTRY[t](d)
    if isinstance(d, TransformedDistribution):
        return Chain((bijector(d.base), inverse(d.transform)))
    s = d.support
    n = d.event_ndims
    if s.kind == "discrete":
        return elementwise(Identity(), n)
    if s.kind == "simplex":
        return SimplexBijector()
    if s.kind == "pd":
        return PDVecBijector()
    if s.kind == "corr":
        return VecCorrBijector()
    if s.kind == "chol_corr":
        return VecCholeskyBijector(getattr(d, "mode", "L"))
    if s.kind == "interval":
        if not s.lower_finite and not s.upper_finite:
            return elementwise(Identity(), n)
        b = Truncated(
            s.lower if s.lower_finite else -math.inf,
            s.upper if s.upper_finite else math.inf,
            lower_finite=s.lower_finite,
            upper_finite=s.upper_finite,
        )
        return elementwise(b, n)
    if s.kind in ("real_vector", "real_matrix"):
        return elementwise(Identity(), n)
    if s.kind == "reshaped":
        # inverse(Reshape) o b o Reshape: the base's link on its own event
        from .bijectors.reshape import Reshape

        inner_shape = tuple(int(v) for v in d.base.event_shape)
        return Chain((bijector(d.base), Reshape(tuple(d.shape), inner_shape)))
    if s.kind == "joint_order":
        # JointOrderWrap (src/vector/order/order.jl:14-76): the base's link
        # elementwise, a sign-flip sandwich for a decreasing one, then
        # unordered by the ordered bijector's inverse
        b_scalar = bijector(d.base)
        eb = Block(b_scalar, 1)
        if b_scalar.monotonically_decreasing:
            flip = Block(SignFlip(), 1)
            return Chain((flip, inverse(OrderedBijector()), flip, eb))
        if not b_scalar.monotonically_increasing:
            raise ValueError(
                "joint order statistics need a monotone scalar link; "
                f"bijector({type(d.base).__name__}) declares neither direction"
            )
        return Chain((inverse(OrderedBijector()), eb))
    raise NotImplementedError(
        f"no bijector ported for {type(d).__name__} ({s.kind})"
    )


def link(d: Distribution, x):
    """Constrained -> unconstrained (reference `link`, src/Bijectors.jl:156)."""
    return bijector(d).forward(x)


def invlink(d: Distribution, y):
    """Unconstrained -> constrained (reference `invlink`, src/Bijectors.jl:183)."""
    return bijector(d).inverse(y)


def _logpdf_eps_safe(d: Distribution, x):
    """logpdf(d, x), with the reference's eps-nudge logpdf(d, x .+ eps) for
    simplex-supported families (src/Bijectors.jl:253)."""
    if d.support.kind == "simplex":
        return d.logpdf(x + _eps(x.dtype))
    return d.logpdf(x)


def logpdf_with_trans(d: Distribution, x, transform: bool = False):
    """logpdf(d, x) - logabsdetjac(bijector(d), x), with the reference's
    Dirichlet eps-nudge (`_logpdf_eps_safe`)."""
    x = torch.as_tensor(x)
    lp = _logpdf_eps_safe(d, x)
    if not transform:
        return lp
    b = bijector(d)
    ld = b.forward_and_log_det(x)[1]
    extra = d.event_ndims - int(b.event_ndims_in)
    if extra > 0:
        ld = torch.sum(ld, dim=tuple(range(-extra, 0)))
    return lp - ld
