"""tpu_bijectors_torch: the PyTorch and CUDA port of `tpu_bijectors`.

The JAX package stays the reference; the port is held against it on the
same inputs. Entry points (`Model`, `unconstrain`, the distribution
constructors) run on `cuda` unless the caller passes `device="cpu"`;
functions on tensors follow the tensor's device. On the card the fused
log-density runs as hand-written CUDA kernels (`kernels/csrc/`); on the
CPU as their plain PyTorch versions.
"""

from . import dists, flows, kernels
from .bijectors import *  # noqa: F403
from .bijectors import __all__ as _bijectors_all
from .compat import (
    columnwise,
    isclosedform,
    isinvertible,
    logabsdetjac,
    logabsdetjacinv,
    output_size,
    transform,
    with_logabsdet_jacobian,
)
from .convert import bijector_from_spec, dist_from_spec
from .flows import InvertibleBatchNorm, PlanarLayer, RadialLayer, RationalQuadraticSpline
from .infer.model import Model
from .registry import bijector, invlink, link, logpdf_with_trans, register_bijector
from .transformed import OrderedDistribution, TransformedDistribution, ordered, transformed
from .vectorize.core import unconstrain

__all__ = _bijectors_all + [
    "columnwise",
    "isclosedform",
    "isinvertible",
    "logabsdetjac",
    "logabsdetjacinv",
    "output_size",
    "transform",
    "with_logabsdet_jacobian",
    "Model",
    "bijector",
    "bijector_from_spec",
    "dist_from_spec",
    "dists",
    "flows",
    "InvertibleBatchNorm",
    "PlanarLayer",
    "RadialLayer",
    "RationalQuadraticSpline",
    "invlink",
    "kernels",
    "link",
    "logpdf_with_trans",
    "register_bijector",
    "OrderedDistribution",
    "TransformedDistribution",
    "ordered",
    "transformed",
    "unconstrain",
]
