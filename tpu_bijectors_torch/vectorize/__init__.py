"""Vectorization API of the port (counterpart of `tpu_bijectors.vectorize`)."""

from .core import (
    IIDUnconstrainer,
    LeafUnconstrainer,
    Optic,
    TransformedUnconstrainer,
    TreeUnconstrainer,
    Unconstrainer,
    UnconstrainerBijector,
    from_linked_vec,
    from_vec,
    linked_optic_vec,
    linked_vec_length,
    optic_vec,
    to_linked_vec,
    to_vec,
    unconstrain,
    vec_length,
)

__all__ = [
    "IIDUnconstrainer",
    "LeafUnconstrainer",
    "Optic",
    "TransformedUnconstrainer",
    "TreeUnconstrainer",
    "Unconstrainer",
    "UnconstrainerBijector",
    "from_linked_vec",
    "from_vec",
    "linked_optic_vec",
    "linked_vec_length",
    "optic_vec",
    "to_linked_vec",
    "to_vec",
    "unconstrain",
    "vec_length",
]
