"""Property-test machinery of the port (counterpart of
`tpu_bijectors.testing`): the distribution-level sweep `test_all`, the
bijector harness and the hand-derived Jacobian oracles."""

from .harness import (
    assert_bijector_ok,
    check_logdet_against_jacobian,
    random_unconstrained,
)
from .oracles import simplex_invlink_jacobian, simplex_link_jacobian
from .sweep import test_all

__all__ = [
    "assert_bijector_ok",
    "check_logdet_against_jacobian",
    "random_unconstrained",
    "simplex_invlink_jacobian",
    "simplex_link_jacobian",
    "test_all",
]
