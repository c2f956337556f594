"""The reference's function-style interface (`transform(b, x)`,
`with_logabsdet_jacobian`, `logabsdetjac`, `logabsdetjacinv`,
`isinvertible`, `isclosedform`, `output_size`, `columnwise`: the export
list of src/Bijectors.jl:49-87), one to one over the method-style surface;
PyTorch counterpart of `tpu_bijectors/compat.py`.
"""

from __future__ import annotations

from .bijectors.base import Bijector, Block, Chain, Invert


def transform(b, x):
    """`transform(b, x)` == b.forward(x)."""
    return b.forward(x)


def with_logabsdet_jacobian(b, x):
    """`with_logabsdet_jacobian(b, x)` == (b(x), log|J| at x)."""
    return b.forward_and_log_det(x)


def logabsdetjac(b, x):
    return b.forward_and_log_det(x)[1]


def logabsdetjacinv(b, y):
    """`logabsdetjac(inverse(b), y)`."""
    return b.inverse_and_log_det(y)[1]


def isinvertible(b) -> bool:
    """Every Bijector is invertible (src/interface.jl:271-273)."""
    return isinstance(b, (Bijector, Invert))


def isclosedform(b) -> bool:
    """False only where an inverse without a closed form appears anywhere
    in `b`, through compositions and wrappers (src/interface.jl:231, the
    conjunctive rule of src/bijectors/composed.jl:1-2)."""
    if isinstance(b, Invert):
        return bool(getattr(b.bijector, "closed_form_inverse", True))
    if isinstance(b, Chain):
        return all(isclosedform(t) for t in b.transforms)
    if isinstance(b, Block):
        return isclosedform(b.bijector)
    return True


def output_size(b, input_shape):
    """`output_size(f, sz)` (src/interface.jl:85-105)."""
    return tuple(b.forward_event_shape(tuple(input_shape)))


def columnwise(b) -> Block:
    """`columnwise(f)`: `b` on each column. Batch axes lead here, so a
    column-batched matrix is (..., n_cols, n_rows) and `Block(b, 1)` maps
    each trailing vector."""
    return Block(b, 1)
