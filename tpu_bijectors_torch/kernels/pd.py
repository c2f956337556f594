"""Positive-definite matrix links: the CUDA kernels' wrappers and their plain
versions (counterpart of `tpu_bijectors/kernels/pd.py`).

y packs the lower triangle of the factor row by row (slot r(r+1)/2 + c for
c <= r, the reference's pd.jl:36-43 order); L has y off the diagonal and
exp(y_rr) on it, X = LL', and the inverse link's log-det is
logJ = sum_r (K+1-r) y_rr + K log 2 (0-based r).

  `pd_inverse(y, K)` (`pd_inverse_pallas`): (X (B, K, K), logJ (B,),
      L (B, K, K)).
  `pd_logdensity(y, K, C, mode)` (`pd_logdensity_pallas`): (logJ, sum of
      y_rr, trace), each (B,), writing neither X nor L. `mode="dot"`:
      trace = sum_ab C_ab X_ab (Wishart, C = S^-1); `mode="solve"`:
      trace = ||L^-1 C||_F^2 (InverseWishart, C = chol(Psi)).
  `pd_trace_grad(y, K, C, mode)` (`pd_trace_grad_pallas`): d trace / d y
      (B, P), the backward of the trace: 2 (C L) in dot mode, -2 At A' in
      solve mode (A = L^-1 C, At = L^-T A), each times L_rr on the
      diagonal slots.

In dot mode C is taken as (C + C') / 2 (the log-density kernel weighs
each pair of rows by C_ab + C_ba itself; the trace gradient's wrapper
symmetrises C), so the trace is tr(C X) and its gradient 2 (C L) for any
C.
The inverse diagonal is exp(-y_rr), as the TPU kernels take it. For a CUDA
tensor each wrapper launches its kernel (`csrc/pd_inverse.cu`,
`csrc/pd_logdensity.cu`, `csrc/pd_trace_grad.cu`) or raises; for a CPU
tensor it runs its plain version. y may be any 2-D strided view, read in
place (the swapped view of a transposed (P, B) state needs no copy, the TPU
kernels' `pre_t`), and the trace gradient comes back in y's layout. The
kernels take 1 <= K <= MAX_K.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..utils import pd_from_lower, set_diag, tril_to_vec, vec_to_tril

LOG2 = math.log(2.0)
MAX_K = 16  # the kernels' half-warp (16-lane) rows and tiles; the loop entry's scratch
MODES = ("dot", "solve")


@lru_cache(maxsize=None)
def _diag_coeffs(K):
    """(K+1-r on the diagonal slots, 0 elsewhere; the diagonal mask), as
    numpy (P,) arrays."""
    diag = np.zeros(K * (K + 1) // 2)
    diag[[r * (r + 1) // 2 + r for r in range(K)]] = 1.0
    coeff = np.zeros_like(diag)
    coeff[diag == 1.0] = K + 1.0 - np.arange(K)
    return coeff, diag


def affine_coeffs(K, like):
    """`_diag_coeffs` as tensors of `like`'s dtype on its device: the slopes
    of logJ and of sum y_rr in each packed slot."""
    coeff, diag = _diag_coeffs(K)
    return (torch.as_tensor(coeff, dtype=like.dtype, device=like.device),
            torch.as_tensor(diag, dtype=like.dtype, device=like.device))


def _unpack(y, K):
    """(L (N, K, K), y_diag (N, K)) from y (N, P)."""
    Y = vec_to_tril(y, 0, K)
    d = torch.diagonal(Y, dim1=-2, dim2=-1)
    return set_diag(Y, torch.exp(d)), d


def _logJ(d, K):
    coeff = torch.arange(K + 1, 1, -1, dtype=d.dtype, device=d.device)
    return torch.sum(coeff * d, dim=-1) + K * LOG2


def _sym(C, mode):
    return 0.5 * (C + C.transpose(-1, -2)) if mode == "dot" else C


def _forward_sub(L, einv, C):
    """A = L^-1 C row by row, A_i = (C_i - sum_{k<i} L_ik A_k) exp(-y_ii),
    the kernels' order of operations."""
    rows = []
    for i in range(L.shape[-1]):
        acc = C[i].expand(L.shape[:-2] + C.shape[-1:])
        for k in range(i):
            acc = acc - L[..., i, k, None] * rows[k]
        rows.append(acc * einv[..., i, None])
    return torch.stack(rows, dim=-2)


def _back_sub(L, einv, A):
    """At = L^-T A, from the last row up."""
    K = L.shape[-1]
    rows = [None] * K
    for i in range(K - 1, -1, -1):
        acc = A[..., i, :]
        for k in range(i + 1, K):
            acc = acc - L[..., k, i, None] * rows[k]
        rows[i] = acc * einv[..., i, None]
    return torch.stack(rows, dim=-2)


def pd_inverse_plain(y, K: int):
    """The plain PyTorch version of `pd_inverse`."""
    L, d = _unpack(y, K)
    return pd_from_lower(L), _logJ(d, K), L


def pd_logdensity_plain(y, K: int, C, mode: str):
    """The plain PyTorch version of `pd_logdensity`."""
    L, d = _unpack(y, K)
    C = _sym(C.to(y.dtype), mode)
    if mode == "dot":
        tr = torch.sum(C * pd_from_lower(L), dim=(-2, -1))
    else:
        A = _forward_sub(L, torch.exp(-d), C)
        tr = torch.sum(A * A, dim=(-2, -1))
    return _logJ(d, K), torch.sum(d, dim=-1), tr


def pd_trace_grad_plain(y, K: int, C, mode: str):
    """The plain PyTorch version of `pd_trace_grad`, in closed form."""
    L, d = _unpack(y, K)
    C = _sym(C.to(y.dtype), mode)
    if mode == "dot":
        G = 2.0 * (C @ L)
    else:
        einv = torch.exp(-d)
        A = _forward_sub(L, einv, C)
        G = -2.0 * (_back_sub(L, einv, A) @ A.transpose(-1, -2))
    return tril_to_vec(set_diag(G, torch.diagonal(G, dim1=-2, dim2=-1) * torch.exp(d)))


def _check_cuda(y, K, C=None):
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the PD kernels take 1 <= K <= {MAX_K}; got K = {K}")
    if y.dtype != torch.float32:
        raise TypeError(f"the PD kernels take float32; got {y.dtype}")
    if y.ndim != 2 or y.shape[1] != K * (K + 1) // 2:
        raise ValueError(f"y must be (B, {K * (K + 1) // 2}); got {tuple(y.shape)}")
    if C is not None and (C.shape != (K, K) or C.device != y.device):
        raise ValueError(f"C must be ({K}, {K}) on {y.device}; got {tuple(C.shape)} on {C.device}")


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")


def _empty(shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _fake_inverse(y, K):
    B = y.shape[0]
    return _empty((B, K, K), y), _empty((B,), y), _empty((B, K, K), y)


@kernels.kernel_op("pd_inverse", "(Tensor y, int K) -> (Tensor, Tensor, Tensor)", _fake_inverse)
def _inverse_launch(y, K):
    """#10 on the card."""
    B = y.shape[0]
    X, logJ, L = _fake_inverse(y, K)
    kernels.launch(
        "tbt_pd_inverse", "pd_inverse", y.device,
        y.data_ptr(), y.stride(0), y.stride(1), X.data_ptr(), logJ.data_ptr(),
        L.data_ptr(), K, B,
    )
    return X, logJ, L


def pd_inverse(y, K: int):
    """(X (B, K, K), logJ (B,), L (B, K, K)) from y (B, K(K+1)/2)."""
    if y.device.type == "cpu":
        return pd_inverse_plain(y, K)
    _check_cuda(y, K)
    return _inverse_launch(y, K)


def _fake_logdensity(y, K, C, solve):
    return tuple(_empty((y.shape[0],), y) for _ in range(3))


@kernels.kernel_op("pd_logdensity",
                   "(Tensor y, int K, Tensor C, bool solve) -> (Tensor, Tensor, Tensor)",
                   _fake_logdensity)
def _logdensity_launch(y, K, C, solve):
    """#11 on the card."""
    B = y.shape[0]
    logJ, sumd, tr = _fake_logdensity(y, K, C, solve)
    kernels.launch(
        "tbt_pd_logdensity", "pd_logdensity", y.device,
        y.data_ptr(), y.stride(0), y.stride(1), C.data_ptr(), logJ.data_ptr(),
        sumd.data_ptr(), tr.data_ptr(), K, int(solve), B,
    )
    return logJ, sumd, tr


def pd_logdensity(y, K: int, C, mode: str):
    """(logJ, sum y_rr, trace), each (B,), from y (B, K(K+1)/2) and C (K, K)."""
    _check_mode(mode)
    if y.device.type == "cpu":
        return pd_logdensity_plain(y, K, C, mode)
    _check_cuda(y, K, C)
    C = C.to(torch.float32).contiguous()  # the kernel takes (C + C') / 2 in dot mode
    return _logdensity_launch(y, K, C, mode == "solve")


def _fake_trace_grad(y, K, C, solve):
    B, P = y.shape
    swapped = y.stride(0) == 1 and y.stride(1) != 1
    return _empty((P, B), y).T if swapped else _empty((B, P), y)


@kernels.kernel_op("pd_trace_grad", "(Tensor y, int K, Tensor C, bool solve) -> Tensor",
                   _fake_trace_grad)
def _trace_grad_launch(y, K, C, solve):
    """#12 on the card: g in y's layout."""
    g = _fake_trace_grad(y, K, C, solve)
    kernels.launch(
        "tbt_pd_trace_grad", "pd_trace_grad", y.device,
        y.data_ptr(), y.stride(0), y.stride(1), C.data_ptr(), g.data_ptr(),
        g.stride(0), g.stride(1), K, int(solve), y.shape[0],
    )
    return g


def pd_trace_grad(y, K: int, C, mode: str):
    """d trace / d y (B, K(K+1)/2), in y's layout: the swapped view of a
    (P, B) block gets the swapped view of a (P, B) tensor."""
    _check_mode(mode)
    if y.device.type == "cpu":
        return pd_trace_grad_plain(y, K, C, mode)
    _check_cuda(y, K, C)
    C = _sym(C.to(torch.float32), mode).contiguous()
    return _trace_grad_launch(y, K, C, mode == "solve")
