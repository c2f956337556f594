"""Numeric utilities (layer L0), PyTorch counterpart of `tpu_bijectors/utils.py`.

Keeps the reference's epsilon semantics (`_eps`, clamps), the numerically
stable special functions, and the column-major strict-upper-triangle index
sets and the row-major lower pack of the PD links (built with numpy, so
packing is a static gather). Also holds the
device rule every entry point of the port follows (`resolve_device`).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

LOG2 = math.log(2.0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never moves work to the CPU because no GPU was found."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def _eps(dtype) -> float:
    """Machine epsilon of a floating dtype (reference `_eps`,
    src/Bijectors.jl:91-93)."""
    return float(torch.finfo(dtype).eps)


def clamp(x, lo, hi):
    """Clamp to [lo, hi] (reference `_clamp`, src/Bijectors.jl:95-100);
    NaNs propagate. Written as min(max(x, lo), hi), as `jnp.clip` is, so
    that autograd splits the slope at a bound the same way (1/2 there)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def max_slope(v, floor):
    """d max(v, floor) / dv: 1 above the floor, 0 below, 1/2 at it (the
    convention of `jnp.maximum` and `torch.maximum`)."""
    return (v > floor).to(v.dtype) + 0.5 * (v == floor).to(v.dtype)


def clamp_slope(v, lo=0.0, hi=1.0):
    """d clamp(v, lo, hi) / dv with `clamp`'s convention at the bounds (1/2
    at either one)."""
    inside = ((v > lo) & (v < hi)).to(v.dtype)
    return inside + 0.5 * ((v == lo) | (v == hi)).to(v.dtype)


def plain_jvp(fn, primals, tangents):
    """The tangents of fn's tensor outputs at `primals` along `tangents`
    (None: a zero tangent), by the double backward of
    `torch.autograd.functional.jvp`. A Function's `jvp` takes the tangent
    of its plain version so, since forward mode does not nest."""
    tangents = tuple(torch.zeros_like(p) if t is None else t for p, t in zip(primals, tangents))
    return torch.autograd.functional.jvp(fn, tuple(primals), tangents)[1]


def logit(p):
    return torch.log(p) - torch.log1p(-p)


def logistic(x):
    return torch.sigmoid(x)


def log1pexp(x):
    """softplus(x) = max(x, 0) + log1p(exp(-|x|)), stable for every x (the
    form of `jax.nn.softplus`; torch's own softplus switches to the
    identity above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def softplus_inv(y):
    """The inverse of softplus: log(expm1(y)) = y + log(-expm1(-y))."""
    return y + torch.log(-torch.expm1(-y))


def logcosh(x):
    """log(cosh(x)) = |x| + log1p(exp(-2|x|)) - log 2, stable for every x."""
    a = torch.abs(x)
    return a + log1pexp(-2.0 * a) - LOG2


@lru_cache(maxsize=None)
def _triu_index_arrays(n: int, k: int):
    """(rows, cols) of the upper triangle with offset k, column-major order
    (reference update_triu_from_vec loop order, src/utils.jl:77-85)."""
    rows, cols = [], []
    for j in range(n):
        for i in range(0, min(j + 1 - k, n)):
            rows.append(i)
            cols.append(j)
    return np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)


def triu_dim_from_length(d: int) -> int:
    """n such that n(n+1)/2 == d (reference `_triu_dim_from_length`,
    src/utils.jl:135)."""
    n = (-1 + math.isqrt(1 + 8 * d)) // 2
    if n * (n + 1) // 2 != d:
        raise ValueError(f"{d} is not a triangular number")
    return n


def triu1_dim_from_length(d: int) -> int:
    """n such that n(n-1)/2 == d (reference `_triu1_dim_from_length`,
    src/utils.jl:99)."""
    n = (1 + math.isqrt(1 + 8 * d)) // 2
    if n * (n - 1) // 2 != d:
        raise ValueError(f"{d} is not of the form n(n-1)/2")
    return n


@lru_cache(maxsize=None)
def _triu_index_tensors(n: int, k: int, device: torch.device):
    """`_triu_index_arrays` as index tensors on `device`, made once."""
    rows, cols = _triu_index_arrays(n, k)
    return torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device)


def triu_to_vec(X, k: int = 0):
    """Pack the upper triangle (offset k) of the trailing (n, n) dims,
    column-major, over any leading batch dims."""
    rows, cols = _triu_index_tensors(X.shape[-1], k, X.device)
    return X[..., rows, cols]


def vec_to_triu(v, k: int, n: int):
    """Inverse of `triu_to_vec`; zeros elsewhere."""
    rows, cols = _triu_index_tensors(n, k, v.device)
    X = v.new_zeros(v.shape[:-1] + (n, n))
    X[..., rows, cols] = v
    return X


def tril_to_vec(X, k: int = 0):
    """Pack the lower triangle (offset -k) of the trailing (n, n) dims as the
    upper triangle of the transpose: row-major, slot r(r+1)/2 + c for
    c <= r at k = 0 (the reference's `pd_vec_link` order,
    src/bijectors/pd.jl:36-43)."""
    return triu_to_vec(X.transpose(-1, -2), k)


def vec_to_tril(v, k: int = 0, n: int | None = None):
    """Inverse of `tril_to_vec`; zeros elsewhere."""
    if n is None:
        n = triu_dim_from_length(v.shape[-1]) if k == 0 else triu1_dim_from_length(v.shape[-1])
    return vec_to_triu(v, k, n).transpose(-1, -2)


def set_diag(X, d):
    """X with its diagonal replaced by d (batched)."""
    eye = torch.eye(X.shape[-1], dtype=torch.bool, device=X.device)
    return torch.where(eye, d[..., :, None], X)


def pd_from_lower(L):
    """L L^T with L forced lower-triangular (src/utils.jl:14-17)."""
    L = torch.tril(L)
    return L @ L.transpose(-1, -2)


def cholesky_lower(X):
    """Lower Cholesky factor of a symmetrised SPD matrix (reference
    `cholesky_lower`, src/utils.jl:37)."""
    return torch.linalg.cholesky(0.5 * (X + X.transpose(-1, -2)))


def pd_from_upper(U):
    """U^T U with U forced upper-triangular (src/utils.jl:18-21)."""
    U = torch.triu(U)
    return U.transpose(-1, -2) @ U


def cholesky_upper(X):
    """Upper Cholesky factor of a symmetrised SPD matrix (src/utils.jl:50)."""
    return cholesky_lower(X).transpose(-1, -2)


def sum_last(x, ndims: int):
    """Sum over the trailing `ndims` axes (0 -> identity)."""
    if ndims == 0:
        return x
    return torch.sum(x, dim=tuple(range(-ndims, 0)))
