"""Trainable normalizing-flow layers of the port (counterpart of
`tpu_bijectors.flows`; reference planar_layer.jl, radial_layer.jl,
rational_quadratic_spline.jl, normalise.jl, coupling.jl), and the two
functions that hand a flow's tensors to an optimiser and back."""

from ..bijectors.coupling import Coupling, PartitionMask
from .maf import MaskedAutoregressive, flow_stack, maf_stack
from .normalise import InvertibleBatchNorm
from .nsf import MaskedAutoregressiveSpline, nsf_ar_stack
from .params import flow_parameters, with_flow_parameters
from .planar import PlanarLayer, find_alpha
from .radial import RadialLayer
from .rqs import RationalQuadraticSpline

__all__ = [
    "PlanarLayer",
    "RadialLayer",
    "RationalQuadraticSpline",
    "InvertibleBatchNorm",
    "Coupling",
    "PartitionMask",
    "find_alpha",
    "MaskedAutoregressive",
    "maf_stack",
    "MaskedAutoregressiveSpline",
    "nsf_ar_stack",
    "flow_stack",
    "flow_parameters",
    "with_flow_parameters",
]
