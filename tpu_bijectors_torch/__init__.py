"""tpu_bijectors_torch: the PyTorch and CUDA port of `tpu_bijectors`.

The JAX package stays the reference; the port is held against it on the
same inputs. Entry points (`Model`, `unconstrain`, the distribution
constructors) run on `cuda` unless the caller passes `device="cpu"`;
functions on tensors follow the tensor's device. On the card the fused
log-density runs as hand-written CUDA kernels (`kernels/csrc/`); on the
CPU as their plain PyTorch versions.
"""

from . import dists, kernels
from .bijectors import Chain, Invert, inverse
from .convert import dist_from_spec
from .infer.model import Model
from .registry import bijector, logpdf_with_trans
from .transformed import TransformedDistribution, transformed
from .vectorize.core import unconstrain

__all__ = [
    "Chain",
    "Invert",
    "Model",
    "bijector",
    "dist_from_spec",
    "dists",
    "inverse",
    "kernels",
    "logpdf_with_trans",
    "TransformedDistribution",
    "transformed",
    "unconstrain",
]
