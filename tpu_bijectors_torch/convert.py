"""Build the port's distributions and bijectors from a plain description.

A spec is a nested dict of type names and numpy arrays, so that the same
parameters can be handed to the JAX package and to the port:

  {"type": "NamedProduct", "children": {"mu": spec, ...}}
  {"type": "Product", "children": [spec, ...]}   (a tuple sample)
  {"type": "IIDProduct", "inner": spec, "n": 8}
  {"type": "ElementwiseProduct", "inner": spec}   (arraydist of (n,) parameters)
  {"type": "TransformedDistribution", "inner": spec}   (transformed(d): the
      base's registry bijector)
  {"type": "Gamma", "params": {"concentration": np.ndarray, "rate": np.ndarray}}
  {"type": "LKJCholesky", "dim": 5, "mode": "L", "params": {"eta": np.ndarray}}
  {"type": "Dirichlet", "params": {"alpha": np.ndarray}}
  {"type": "LKJ", "dim": 16, "params": {"eta": np.ndarray}}
  {"type": "Wishart", "params": {"df": np.ndarray, "scale": np.ndarray}}
  {"type": "InverseWishart", "params": {"df": np.ndarray, "psi": np.ndarray}}
  {"type": "MvNormalTril", "params": {"loc": np.ndarray, "scale_tril": np.ndarray}}

(and alike every scalar family of `dists/univariate*.py`, MvNormalDiag and
MvLogNormal {loc, scale_diag}, MvStudentT {df, loc, scale_tril},
MvNormalCanon {h, prec}: the JAX families' fields). The wrappers nest a
spec under the field that holds a distribution:

  {"type": "Truncated", "base": spec, "params": {"lower": -0.5, "upper": 2.0}}
  {"type": "Mixture", "components": spec, "params": {"log_weights": np.ndarray}}
  {"type": "JointOrderStatistics", "base": spec, "n": 4}

Any other key than "type", "params", "children" and "inner" is a static
argument of the constructor (an int such as `n` or `dim`, a string such
as `mode`, or a nested spec).

A bijector's spec has the same form, from the fields of a JAX bijector:

  {"type": "Shift", "params": {"a": np.ndarray}}   (a float stays a float:
      Scale(2.0) keeps its static direction)
  {"type": "Permute", "perm": (2, 0, 1)}
  {"type": "TriangularLinearMap", "params": {"T": np.ndarray}, "lower": False}
  {"type": "Chain", "children": [spec, ...]}   (outer first, as Chain's)
  {"type": "Stacked", "children": [spec, ...], "ranges_in": ((0, 2), ...)}
  {"type": "ProductBijector", "children": [spec, ...]}
  {"type": "NamedTransform", "children": {"a": spec, ...}}
  {"type": "Block", "inner": spec, "ndims": 1}
  {"type": "Invert", "inner": spec}
"""

from __future__ import annotations

import numpy as np
import torch

from . import bijectors, dists
from .transformed import transformed

_SCALAR = (
    "Normal", "StudentT", "Cauchy", "Laplace", "Logistic", "Gumbel", "LogNormal",
    "Exponential", "Gamma", "InverseGamma", "Chi", "Weibull", "Rayleigh", "Frechet",
    "HalfNormal", "HalfCauchy", "Beta", "LogitNormal", "Uniform", "Pareto", "Levy",
    "Kumaraswamy", "Arcsine", "SkewNormal", "BetaPrime", "InverseGaussian",
    "TriangularDist", "JohnsonSU", "Mixture",
)
_LEAVES = {name: getattr(dists, name) for name in _SCALAR}
_LEAVES.update({
    "Dirichlet": dists.Dirichlet,
    "LKJ": dists.LKJ,
    "LKJCholesky": dists.LKJCholesky,
    "Wishart": dists.Wishart,
    "InverseWishart": dists.InverseWishart,
    "MvNormalDiag": dists.MvNormalDiag,
    "MvNormalTril": dists.MvNormalTril,
    "MvLogNormal": dists.MvLogNormal,
    "MvStudentT": dists.MvStudentT,
    "MvNormalCanon": dists.MvNormalCanon,
})


def dist_from_spec(spec: dict, *, device, dtype):
    """The port's distribution for `spec`, its parameters as `dtype`
    tensors on `device`."""
    kind = spec["type"]
    if kind == "NamedProduct":
        return dists.NamedProduct.of(
            **{
                name: dist_from_spec(c, device=device, dtype=dtype)
                for name, c in spec["children"].items()
            }
        )
    if kind == "Product":
        return dists.Product(
            tuple(dist_from_spec(c, device=device, dtype=dtype) for c in spec["children"])
        )
    if kind == "IIDProduct":
        return dists.IIDProduct(
            dist_from_spec(spec["inner"], device=device, dtype=dtype), int(spec["n"])
        )
    if kind == "ElementwiseProduct":
        return dists.arraydist(dist_from_spec(spec["inner"], device=device, dtype=dtype))
    if kind == "TransformedDistribution":
        return transformed(dist_from_spec(spec["inner"], device=device, dtype=dtype))
    static = {
        k: dist_from_spec(v, device=device, dtype=dtype) if isinstance(v, dict) else v
        for k, v in spec.items() if k not in ("type", "params")
    }
    if kind in ("Truncated", "JointOrderStatistics"):
        # static bounds and counts: no tensor parameter of their own
        args = {**static, **{k: float(v) for k, v in spec.get("params", {}).items()}}
        return getattr(dists, kind)(**args)
    if kind not in _LEAVES:
        raise NotImplementedError(f"no ported distribution named {kind!r}")
    return _LEAVES[kind](**static, **spec.get("params", {}), device=device, dtype=dtype)


def bijector_from_spec(spec: dict, *, device, dtype):
    """The port's bijector for `spec`, its array fields as `dtype` tensors
    on `device`."""
    kind = spec["type"]

    def rec(s):
        return bijector_from_spec(s, device=device, dtype=dtype)

    if kind == "Chain":
        return bijectors.Chain(tuple(rec(c) for c in spec["children"]))
    if kind == "Stacked":
        return bijectors.Stacked(tuple(rec(c) for c in spec["children"]),
                                 tuple(tuple(r) for r in spec["ranges_in"]))
    if kind == "ProductBijector":
        return bijectors.ProductBijector(tuple(rec(c) for c in spec["children"]))
    if kind == "NamedTransform":
        return bijectors.NamedTransform.of(**{k: rec(c) for k, c in spec["children"].items()})
    if kind in ("Block", "Invert"):
        static = {k: v for k, v in spec.items() if k not in ("type", "inner")}
        return getattr(bijectors, kind)(rec(spec["inner"]), **static)
    params = {k: torch.as_tensor(v, dtype=dtype, device=device) if isinstance(v, np.ndarray)
              else v for k, v in spec.get("params", {}).items()}
    static = {k: v for k, v in spec.items() if k not in ("type", "params")}
    return getattr(bijectors, kind)(**static, **params)
