"""Vectorization API of the port (counterpart of `tpu_bijectors.vectorize`)."""

from .core import (
    IIDUnconstrainer,
    LeafUnconstrainer,
    TreeUnconstrainer,
    Unconstrainer,
    unconstrain,
)

__all__ = [
    "IIDUnconstrainer",
    "LeafUnconstrainer",
    "TreeUnconstrainer",
    "Unconstrainer",
    "unconstrain",
]
