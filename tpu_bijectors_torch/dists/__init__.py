"""Distribution families of the port (counterpart of `tpu_bijectors.dists`)."""

from .base import (
    CORRELATION,
    POSITIVE_DEFINITE,
    SIMPLEX,
    Distribution,
    LeafDistribution,
    Support,
)
from .matrix import LKJ, InverseWishart, Wishart
from .multivariate import Dirichlet
from .product import IIDProduct, NamedProduct
from .univariate import LogNormal, Normal

__all__ = [
    "CORRELATION",
    "POSITIVE_DEFINITE",
    "SIMPLEX",
    "Distribution",
    "LeafDistribution",
    "Support",
    "LKJ",
    "InverseWishart",
    "Wishart",
    "Dirichlet",
    "IIDProduct",
    "NamedProduct",
    "LogNormal",
    "Normal",
]
