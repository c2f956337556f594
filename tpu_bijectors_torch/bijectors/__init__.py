"""Bijectors of the port (counterpart of `tpu_bijectors.bijectors`)."""

from .base import (
    Bijector,
    Block,
    Chain,
    Identity,
    Invert,
    Transform,
    elementwise,
    inverse,
)
from .cdf_quantile import CDFBijector, QuantileBijector
from .corr import CorrBijector, VecCholeskyBijector, VecCorrBijector
from .coupling import Coupling, PartitionMask
from .linear import LinearMap, TriangularLinearMap
from .ordered import OrderedBijector
from .pd import CholeskyVecBijector, PDBijector, PDVecBijector
from .product import NamedCoupling, NamedTransform, ProductBijector
from .reshape import Permute, Reshape
from .scalar import Exp, LeakyReLU, Log, Logit, Scale, Shift, SignFlip, Softplus, Truncated
from .simplex import SimplexBijector
from .stacked import Stacked

__all__ = [
    "Bijector",
    "Block",
    "Chain",
    "Identity",
    "Invert",
    "Transform",
    "elementwise",
    "inverse",
    "CDFBijector",
    "QuantileBijector",
    "CorrBijector",
    "VecCholeskyBijector",
    "VecCorrBijector",
    "Coupling",
    "PartitionMask",
    "LinearMap",
    "TriangularLinearMap",
    "CholeskyVecBijector",
    "PDBijector",
    "PDVecBijector",
    "OrderedBijector",
    "NamedCoupling",
    "NamedTransform",
    "ProductBijector",
    "Permute",
    "Reshape",
    "Exp",
    "LeakyReLU",
    "Log",
    "Logit",
    "Scale",
    "Shift",
    "SignFlip",
    "Softplus",
    "Truncated",
    "SimplexBijector",
    "Stacked",
]
