"""Distribution families of the port (counterpart of `tpu_bijectors.dists`)."""

from .base import (
    CORRELATION,
    POSITIVE_DEFINITE,
    REAL_VECTOR,
    SIMPLEX,
    Distribution,
    LeafDistribution,
    Support,
)
from .matrix import LKJ, InverseWishart, Wishart
from .multivariate import (
    Dirichlet,
    MvLogNormal,
    MvNormal,
    MvNormalCanon,
    MvNormalDiag,
    MvNormalTril,
    MvStudentT,
)
from .product import IIDProduct, NamedProduct
from .univariate import LogNormal, Normal

__all__ = [
    "CORRELATION",
    "POSITIVE_DEFINITE",
    "REAL_VECTOR",
    "SIMPLEX",
    "Distribution",
    "LeafDistribution",
    "Support",
    "LKJ",
    "InverseWishart",
    "Wishart",
    "Dirichlet",
    "MvLogNormal",
    "MvNormal",
    "MvNormalCanon",
    "MvNormalDiag",
    "MvNormalTril",
    "MvStudentT",
    "IIDProduct",
    "NamedProduct",
    "LogNormal",
    "Normal",
]
