"""Bijectors of the port (counterpart of `tpu_bijectors.bijectors`)."""

from .base import Bijector, Block, Chain, Identity, Invert, elementwise, inverse
from .corr import VecCholeskyBijector, VecCorrBijector
from .pd import CholeskyVecBijector, PDBijector, PDVecBijector
from .ordered import OrderedBijector
from .scalar import SignFlip, Truncated
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
    "OrderedBijector",
    "SignFlip",
    "Truncated",
    "SimplexBijector",
]
