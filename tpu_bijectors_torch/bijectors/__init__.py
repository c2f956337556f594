"""Bijectors of the port (counterpart of `tpu_bijectors.bijectors`)."""

from .base import Bijector, Block, Chain, Identity, Invert, elementwise, inverse
from .corr import VecCholeskyBijector, VecCorrBijector
from .pd import CholeskyVecBijector, PDBijector, PDVecBijector
from .scalar import Truncated
from .simplex import SimplexBijector

__all__ = [
    "Bijector",
    "Block",
    "Chain",
    "Identity",
    "Invert",
    "elementwise",
    "inverse",
    "VecCholeskyBijector",
    "VecCorrBijector",
    "CholeskyVecBijector",
    "PDBijector",
    "PDVecBijector",
    "Truncated",
    "SimplexBijector",
]
