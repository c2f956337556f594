"""CDF and quantile bijectors, PyTorch counterparts of
`tpu_bijectors/bijectors/cdf_quantile.py` (reference
src/bijectors/cdf_quantile.jl):

  CDFBijector(d):      support(d) -> (0, 1), x -> cdf(d, x); log|J| = logpdf(d, x)
  QuantileBijector(d): (0, 1) -> support(d), q -> quantile(d, q);
                       log|J| = -logpdf(d, y) at y = quantile(d, q)

Each is the other's inverse (cdf_quantile.jl:92-93). A family without a
closed-form quantile takes the generic solve on its cdf, differentiable by
the implicit-function rule (`dists/base.py`).
"""

from __future__ import annotations

from .base import Bijector, bijector_dataclass


def has_cdf(d) -> bool:
    """True where `d`'s family implements cdf rather than inheriting the
    base's raise; the generic quantile then works too."""
    from ..dists.base import Distribution

    for klass in type(d).__mro__:
        if "cdf" in vars(klass):
            return klass is not Distribution
    return False


def _check_usable(d, name):
    """A TypeError for a vector, discrete or cdf-less family."""
    ev = getattr(d, "event_ndims", 0)
    if ev != 0:
        raise TypeError(f"{name} needs a scalar-event distribution; "
                        f"{type(d).__name__} has event_ndims={ev}")
    if d.support.kind == "discrete":
        raise TypeError(f"{name}({type(d).__name__}): a discrete family has a step cdf, "
                        "which is not invertible")
    if not has_cdf(d):
        raise TypeError(f"{name}({type(d).__name__}): this family has no cdf (no closed "
                        "form: SkewNormal among the port's families)")


@bijector_dataclass
class CDFBijector(Bijector):
    """x -> cdf(d, x), log|J| = logpdf(d, x)."""

    dist: object

    monotonically_increasing = True

    def __post_init__(self):
        _check_usable(self.dist, "CDFBijector")

    def forward_and_log_det(self, x):
        return self.dist.cdf(x), self.dist.logpdf(x)

    def forward(self, x):
        return self.dist.cdf(x)

    def inverse_and_log_det(self, y):
        x = self.dist.quantile(y)
        return x, -self.dist.logpdf(x)

    def inverse(self, y):
        return self.dist.quantile(y)

    def _self_inverse(self):
        return QuantileBijector(self.dist)


@bijector_dataclass
class QuantileBijector(Bijector):
    """q -> quantile(d, q), log|J| = -logpdf(d, quantile(d, q))."""

    dist: object

    monotonically_increasing = True

    def __post_init__(self):
        _check_usable(self.dist, "QuantileBijector")

    def forward_and_log_det(self, q):
        y = self.dist.quantile(q)
        return y, -self.dist.logpdf(y)

    def forward(self, q):
        return self.dist.quantile(q)

    def inverse_and_log_det(self, y):
        return self.dist.cdf(y), self.dist.logpdf(y)

    def inverse(self, y):
        return self.dist.cdf(y)

    def _self_inverse(self):
        return CDFBijector(self.dist)
