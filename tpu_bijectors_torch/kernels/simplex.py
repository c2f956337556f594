"""Stick-breaking simplex link: the CUDA kernels' wrappers and their plain
versions (counterpart of `tpu_bijectors/kernels/simplex.py`).

- `simplex_inverse_logdet(y, am1, want_x)` (`_simplex_fused_pallas`) maps
  y (B, K-1) to the simplex point x (B, K) (or None), the inverse log-det
  (B,) and, given the weights am1 (K,), the Dirichlet data term
  wlog = sum_k am1[k] log(x_k + eps) (B,) (or None);
- `simplex_inverse(y)` (`simplex_inverse_pallas`) maps y to x alone;
- `simplex_forward_logdet(x)` (`simplex_forward_logdet_pallas`) maps x
  (B, K) to y (B, K-1) and the forward log-det (B,) in one pass.

For a CUDA tensor each launches its kernel (`csrc/simplex_inv.cu`, the
first two; `csrc/simplex_fwd.cu`) or raises; for a CPU tensor it runs its
plain version. The input may be any 2-D strided view: the kernels read it
through its strides, so the swapped view of a transposed (dim, B) state is
read in place. The inverse kernels have two designs, chosen by the batch
(`simplex_design`): a group of lanes an element for a sampler's few chains
(counted as `simplex_inverse_logdet_small` for the first), a thread an
element above SMALL_B; both give the same x bit for bit.

The plain versions' recurrence, forward link and log-det live here, beside
the kernels they define; `bijectors/simplex.py` builds the bijector on
them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..utils import _eps, clamp, logistic, logit


@lru_cache(maxsize=None)
def _log_coeffs(K: int, dtype, device):
    """log(K-1-k) for k = 0..K-2, from float64 rounded to `dtype`, made once
    per (K, dtype, device); the kernel reads the float32 table."""
    return torch.as_tensor(np.log(np.arange(K - 1, 0, -1)), dtype=dtype, device=device)


def _log_km1_minus_k(K: int, like):
    return _log_coeffs(K, like.dtype, like.device)


@lru_cache(maxsize=None)
def _first(n: int, device):
    # (n,) mask of coordinate 0
    return torch.arange(n, device=device) == 0


def _exclusive_prefix(x, K):
    # s_k = sum_{i<k} x_i for k = 0..K-2
    s = torch.cumsum(x[..., : K - 2], dim=-1)
    return torch.cat([torch.zeros_like(x[..., :1]), s], dim=-1)


def simplex_inverse_sequential(y):
    """Exact reference recurrence (simplex.jl:84-100) over K-1 steps; every
    batch dim rides along in each step. #7's and #8's own order of
    operations, and the plain version below ASSOC_SCAN_MIN_K."""
    K = y.shape[-1] + 1
    eps = _eps(y.dtype)
    z = logistic(y - _log_km1_minus_k(K, y))
    s = torch.zeros_like(z[..., 0])
    xs = []
    for k in range(K - 1):
        zk = z[..., k]
        if k == 0:
            xk = clamp((zk - eps) / (1 - 2 * eps), 0.0, 1.0)
        else:
            xk = clamp(((1 + eps) - s) / (1 - 2 * eps) * zk - eps, 0.0, 1.0)
        s = s + xk
        xs.append(xk)
    xs.append(clamp(1.0 - s, 0.0, 1.0))
    return torch.stack(xs, dim=-1)


def affine_scan(a, b):
    """Inclusive scan of the affine maps s -> a_k s + b_k along the last
    axis, applied in order: B[..., k] is the image of 0 under maps 0..k.
    Hillis-Steele doubling, log2(n) steps of elementwise ops (the
    composition (fa, fb) then (ga, gb) is (fa ga, ga fb + gb), the
    associative operator of `jax.lax.associative_scan` in the JAX
    package's simplex inverse)."""
    n, d = a.shape[-1], 1
    while d < n:
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], dim=-1)
        a = torch.cat([a[..., :d], a[..., :-d] * a[..., d:]], dim=-1)
        d *= 2
    return b


def simplex_inverse_scan(y):
    """The log-depth stick-breaking inverse (the JAX package's
    `_simplex_inverse_parallel`): the running sum is affine in s,

        s_1 = (z_0 - eps)/(1-2eps),
        s_{k+1} = (1 - z_k/(1-2eps)) s_k + (1+eps) z_k/(1-2eps) - eps,

    so every prefix comes out of one `affine_scan`, clipped to [0, 1]
    (the sequential clamps keep it there), and x is recovered elementwise
    with the sequential path's clamps. The plain version at K >=
    ASSOC_SCAN_MIN_K, as in the JAX package."""
    K = y.shape[-1] + 1
    eps = _eps(y.dtype)
    c12 = 1 - 2 * eps
    z = logistic(y - _log_km1_minus_k(K, y))
    k0 = _first(K - 1, y.device)
    a = torch.where(k0, torch.ones_like(z), 1.0 - z / c12)
    b = torch.where(k0, (z - eps) / c12, (1 + eps) * z / c12 - eps)
    B = affine_scan(a, b)
    s = clamp(torch.cat([torch.zeros_like(B[..., :1]), B[..., :-1]], dim=-1), 0.0, 1.0)
    x_first = clamp((z - eps) / c12, 0.0, 1.0)
    x_rest = clamp(((1 + eps) - s) / c12 * z - eps, 0.0, 1.0)
    x_last = clamp(1.0 - clamp(B[..., -1], 0.0, 1.0), 0.0, 1.0)
    return torch.cat([torch.where(k0, x_first, x_rest), x_last[..., None]], dim=-1)


# above this K the plain version takes the log-depth scan, as the JAX
# package's jnp path does (tpu_bijectors/bijectors/simplex.py
# `_ASSOC_SCAN_MIN_K`); the kernels keep the sequential recurrence
ASSOC_SCAN_MIN_K = 128
METHODS = ("sequential", "scan")


def simplex_inverse_plain(y, method=None):
    """The plain version of `simplex_inverse`, and the x of
    `simplex_inverse_logdet`: `simplex_inverse_sequential` below
    ASSOC_SCAN_MIN_K, `simplex_inverse_scan` from it on; `method`
    ("sequential" or "scan") overrides the choice."""
    if method is None:
        method = "scan" if y.shape[-1] + 1 >= ASSOC_SCAN_MIN_K else "sequential"
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}; got {method!r}")
    return (simplex_inverse_scan if method == "scan" else simplex_inverse_sequential)(y)


def _inverse_logdet_from_x(x):
    """The inverse log-det as a function of the simplex point x (..., K):
    minus the forward log-det (simplex.jl:104-138), from the running sum of
    x with the reference's floors."""
    K = x.shape[-1]
    eps = x.new_tensor(_eps(x.dtype))
    s = _exclusive_prefix(x, K)
    rem = torch.maximum(1.0 - s, eps)
    xk = x[..., : K - 1]
    k_is_zero = _first(K - 1, x.device)
    z = torch.where(k_is_zero, xk, xk / rem)
    lp = torch.log(torch.maximum(z, eps)) + torch.log(torch.maximum(1.0 - z, eps))
    lp = lp + torch.where(k_is_zero, torch.zeros_like(rem), torch.log(rem))
    return torch.sum(lp, dim=-1)


def simplex_inverse_logdet_plain(y, am1=None, want_x: bool = True, method=None):
    """The plain PyTorch version: the recurrence (`method` as in
    `simplex_inverse_plain`), the log-det from x, and wlog with the
    reference's eps algebra and clamps."""
    x = simplex_inverse_plain(y, method)
    ld = _inverse_logdet_from_x(x)
    wlog = None if am1 is None else torch.sum(am1 * torch.log(x + _eps(x.dtype)), dim=-1)
    return (x if want_x else None), ld, wlog


def simplex_forward_logdet_plain(x):
    """The plain PyTorch version of `simplex_forward_logdet`: the forward
    link y (..., K-1) (simplex.jl:28-64: logit(z) + log(K-1-k), z from the
    exclusive prefix sum of x with the eps algebra of the module docstring
    of `bijectors/simplex.py`) and minus the inverse log-det."""
    K = x.shape[-1]
    eps = _eps(x.dtype)
    s = _exclusive_prefix(x, K)
    xk = x[..., : K - 1]
    z_first = xk * (1 - 2 * eps) + eps
    z_rest = (xk + eps) * (1 - 2 * eps) / ((1 + eps) - s)
    z = torch.where(_first(K - 1, x.device), z_first, z_rest)
    return logit(z) + _log_km1_minus_k(K, x), -_inverse_logdet_from_x(x)


# the inverse kernels take the group design at B <= SMALL_B and the design
# of a thread an element above: the crossover of chip_smoke.py's
# `simplex_small_b_sweep` on the H100 (PERF.md section 6)
SMALL_B = 8192
DESIGNS = ("small", "wide")


def simplex_design(B: int) -> str:
    """The inverse kernels' design at batch B: "small" (a group of lanes
    an element) at B <= SMALL_B, else "wide" (a thread an element)."""
    return "small" if B <= SMALL_B else "wide"


def _design(B, design):
    design = simplex_design(B) if design is None else design
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}; got {design!r}")
    return design


def _check_cuda(y, am1=None):
    if y.dtype != torch.float32:
        raise TypeError(f"the simplex kernels take float32; got {y.dtype}")
    if y.ndim != 2 or y.shape[1] < 1:
        raise ValueError(f"y must be (B, K-1) with K >= 2; got {tuple(y.shape)}")
    if am1 is not None:
        if am1.device != y.device or am1.dtype != y.dtype:
            raise ValueError(f"am1 on {am1.device} {am1.dtype}, y on {y.device} {y.dtype}")
        if am1.shape != (y.shape[1] + 1,) or not am1.is_contiguous():
            raise ValueError(f"am1 must be contiguous ({y.shape[1] + 1},); got {tuple(am1.shape)}")


def _empty(shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _fake_inverse_logdet(y, coeffs, am1, want_x, small):
    B, Km1 = y.shape
    return (_empty((B, Km1 + 1) if want_x else (0,), y), _empty((B,), y),
            _empty((B,) if am1 is not None else (0,), y))


@kernels.kernel_op(
    "simplex_inverse_logdet",
    "(Tensor y, Tensor coeffs, Tensor? am1, bool want_x, bool small) -> (Tensor, Tensor, Tensor)",
    _fake_inverse_logdet)
def _inverse_logdet_launch(y, coeffs, am1, want_x, small):
    """#7 on the card: (x or an empty (0,), ld, wlog or an empty (0,))."""
    B, Km1 = y.shape
    x, ld, wlog = _fake_inverse_logdet(y, coeffs, am1, want_x, small)
    ptr = lambda t, on: t.data_ptr() if on else None  # noqa: E731
    kernels.launch(
        "tbt_simplex_inverse_logdet",
        "simplex_inverse_logdet_small" if small else "simplex_inverse_logdet", y.device,
        y.data_ptr(), y.stride(0), y.stride(1), coeffs.data_ptr(),
        ptr(am1, am1 is not None), ptr(x, want_x), ld.data_ptr(),
        ptr(wlog, am1 is not None), Km1, int(small), B,
    )
    return x, ld, wlog


def simplex_inverse_logdet(y, am1=None, want_x: bool = True, design=None):
    """(x (B, K) or None, ld (B,), wlog (B,) or None) from y (B, K-1).
    `design` ("small" or "wide") overrides `simplex_design(B)` on the card."""
    if y.device.type == "cpu":
        return simplex_inverse_logdet_plain(y, am1, want_x)
    _check_cuda(y, am1)
    B, Km1 = y.shape
    small = _design(B, design) == "small"
    x, ld, wlog = _inverse_logdet_launch(y, _log_km1_minus_k(Km1 + 1, y), am1, want_x, small)
    return (x if want_x else None), ld, (None if am1 is None else wlog)


def _fake_inverse(y, coeffs, small):
    return _empty((y.shape[0], y.shape[1] + 1), y)


@kernels.kernel_op("simplex_inverse", "(Tensor y, Tensor coeffs, bool small) -> Tensor",
                   _fake_inverse)
def _inverse_launch(y, coeffs, small):
    """#8 on the card."""
    B, Km1 = y.shape
    x = _fake_inverse(y, coeffs, small)
    kernels.launch(
        "tbt_simplex_inverse", "simplex_inverse", y.device,
        y.data_ptr(), y.stride(0), y.stride(1), coeffs.data_ptr(),
        x.data_ptr(), Km1, int(small), B,
    )
    return x


def simplex_inverse(y, design=None):
    """x (B, K) from y (B, K-1), with no log-det; `design` as in
    `simplex_inverse_logdet`."""
    if y.device.type == "cpu":
        return simplex_inverse_plain(y)
    _check_cuda(y)
    B, Km1 = y.shape
    return _inverse_launch(y, _log_km1_minus_k(Km1 + 1, y), _design(B, design) == "small")


def _fake_forward_logdet(x, coeffs):
    B, K = x.shape
    return _empty((B, K - 1), x), _empty((B,), x)


@kernels.kernel_op("simplex_forward_logdet", "(Tensor x, Tensor coeffs) -> (Tensor, Tensor)",
                   _fake_forward_logdet)
def _forward_logdet_launch(x, coeffs):
    """#9 on the card."""
    B, K = x.shape
    y, ld = _fake_forward_logdet(x, coeffs)
    kernels.launch(
        "tbt_simplex_forward_logdet", "simplex_forward_logdet", x.device,
        x.data_ptr(), x.stride(0), x.stride(1), coeffs.data_ptr(),
        y.data_ptr(), ld.data_ptr(), K, B,
    )
    return y, ld


def simplex_forward_logdet(x):
    """(y (B, K-1), forward log-det (B,)) from x (B, K) in one pass."""
    if x.device.type == "cpu":
        return simplex_forward_logdet_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"the simplex kernels take float32; got {x.dtype}")
    if x.ndim != 2 or x.shape[1] < 2:
        raise ValueError(f"x must be (B, K) with K >= 2; got {tuple(x.shape)}")
    return _forward_logdet_launch(x, _log_km1_minus_k(x.shape[1], x))
