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

(and alike every family of `dists/univariate*.py` and `dists/discrete.py`,
MvNormalDiag and MvLogNormal {loc, scale_diag}, MvStudentT {df, loc,
scale_tril}, MvNormalCanon {h, prec}, MvLogitNormal {loc, scale_tril},
Multinomial (n) {p}, MatrixBeta (p) {n1, n2}, MatrixTDist {df, loc,
row_scale, col_scale}, MatrixNormal {loc, row_chol, col_chol}: the JAX
families' fields; an int field such as Binomial's `n` is static, and
Soliton's `delta` is a float). The wrappers nest a spec under the field
that holds a distribution:

  {"type": "Truncated", "base": spec, "params": {"lower": -0.5, "upper": 2.0}}
  {"type": "Censored", "base": spec, "params": {"lower": -1.0, "upper": 1.0}}
  {"type": "Affine", "base": spec, "params": {"loc": 1.0, "scale": 2.0}}   (a
      zero-dim loc or scale is a static float, as `d + 1` builds it)
  {"type": "Mixture", "components": spec, "params": {"log_weights": np.ndarray}}
  {"type": "HeterogeneousMixture", "components": [spec, ...],
      "params": {"log_weights": np.ndarray}}
  {"type": "JointOrderStatistics", "base": spec, "n": 4}
  {"type": "OrderStatistic", "base": spec, "n": 5, "rank": 2}
  {"type": "Reshaped", "base": spec, "shape": (2, 3)}   (or "params":
      {"shape": np.ndarray})

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

and the flow layers alike (`flows`), their array fields, the MADE masks
among them, under "params":

  {"type": "PlanarLayer", "params": {"w": ..., "u": ..., "b": ...}}
  {"type": "MaskedAutoregressive", "params": {"w1": ..., ..., "mask1": ...,
      "mask2": ...}, "scale_cap": 3.0}
  {"type": "MaskedAutoregressiveSpline", "params": {...}, "n_bins": 8, "B": 4.0}

(RadialLayer, RationalQuadraticSpline with its static "B",
InvertibleBatchNorm with "eps" and "mtm"); a stack is a "Chain" of them
and Permutes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bijectors, dists, flows
from .transformed import transformed

_SCALAR = (
    "Normal", "StudentT", "Cauchy", "Laplace", "Logistic", "Gumbel", "LogNormal",
    "Exponential", "Gamma", "InverseGamma", "Chi", "Weibull", "Rayleigh", "Frechet",
    "HalfNormal", "HalfCauchy", "Beta", "LogitNormal", "Uniform", "Pareto", "Levy",
    "Kumaraswamy", "Arcsine", "SkewNormal", "BetaPrime", "InverseGaussian",
    "TriangularDist", "JohnsonSU", "Mixture", "Chisq", "FDist", "VonMises", "Semicircle",
    "Cosine", "Epanechnikov", "GeneralizedPareto", "GeneralizedExtremeValue", "Gompertz",
    "Erlang", "LogUniform", "NormalCanon", "Biweight", "Triweight", "SymTriangularDist",
    "PGeneralizedGaussian", "Rician", "Lindley", "Kolmogorov", "NoncentralChisq",
    "NoncentralBeta", "NoncentralF", "NoncentralT", "NormalInverseGaussian",
    "SkewedExponentialPower", "StudentizedRange", "KSOneSided",
)
_DISCRETE = (
    "Poisson", "Bernoulli", "Binomial", "Geometric", "Categorical", "NegativeBinomial",
    "BernoulliLogit", "BetaBinomial", "Dirac", "DiscreteUniform", "DiscreteNonParametric",
    "Hypergeometric", "PoissonBinomial", "Skellam", "Soliton", "Multinomial",
)
_LEAVES = {name: getattr(dists, name) for name in _SCALAR + _DISCRETE}
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
    "MvLogitNormal": dists.MvLogitNormal,
    "MatrixBeta": dists.MatrixBeta,
    "MatrixTDist": dists.MatrixTDist,
    "MatrixNormal": dists.MatrixNormal,
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

    def rec(v):
        if isinstance(v, dict):
            return dist_from_spec(v, device=device, dtype=dtype)
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], dict):
            return tuple(rec(c) for c in v)
        return v

    static = {k: rec(v) for k, v in spec.items() if k not in ("type", "params")}
    params = dict(spec.get("params", {}))
    if kind in ("Truncated", "Censored", "JointOrderStatistics", "OrderStatistic"):
        # static bounds and counts: no tensor parameter of their own
        return getattr(dists, kind)(**static, **{k: float(v) for k, v in params.items()})
    if kind == "Reshaped":
        shape = static.pop("shape", params.pop("shape", None))
        return dists.Reshaped(**static, shape=tuple(int(s) for s in np.ravel(shape)))
    if kind == "Affine":
        # a zero-dim loc or scale is static, as `d + 1` or `d * -3` build it
        for k, v in params.items():
            params[k] = float(v) if np.ndim(v) == 0 else torch.as_tensor(
                np.asarray(v), dtype=dtype, device=device)
        return dists.affine(static.pop("base"), **params)
    if kind == "HeterogeneousMixture":
        return dists.HeterogeneousMixture(**static, **params, device=device, dtype=dtype)
    if kind not in _LEAVES:
        raise NotImplementedError(f"no ported distribution named {kind!r}")
    if kind == "Soliton" and "delta" in params:
        static["delta"] = float(params.pop("delta"))  # a static float
    return _LEAVES[kind](**static, **params, device=device, dtype=dtype)


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
    cls = getattr(bijectors, kind, None) or getattr(flows, kind)
    return cls(**static, **params)
