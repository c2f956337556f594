"""Bijectors of the port (counterpart of `tpu_bijectors.bijectors`)."""

from .base import Bijector, Block, Identity, elementwise
from .corr import VecCorrBijector
from .scalar import Truncated
from .simplex import SimplexBijector

__all__ = [
    "Bijector",
    "Block",
    "Identity",
    "elementwise",
    "VecCorrBijector",
    "Truncated",
    "SimplexBijector",
]
