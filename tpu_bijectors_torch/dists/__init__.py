"""Distribution families of the port (counterpart of `tpu_bijectors.dists`)."""

from .base import CORRELATION, SIMPLEX, Distribution, LeafDistribution, Support
from .matrix import LKJ
from .multivariate import Dirichlet
from .product import IIDProduct, NamedProduct
from .univariate import LogNormal, Normal

__all__ = [
    "CORRELATION",
    "SIMPLEX",
    "Distribution",
    "LeafDistribution",
    "Support",
    "LKJ",
    "Dirichlet",
    "IIDProduct",
    "NamedProduct",
    "LogNormal",
    "Normal",
]
