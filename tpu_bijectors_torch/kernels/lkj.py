"""LKJ / correlation-matrix inverse link: the CUDA kernels' wrappers and
their plain versions (counterpart of `tpu_bijectors/kernels/lkj.py`).

`lkj_inverse(y, K, want_w)` (`lkj_inverse_pallas`) maps the packed y
(B, K(K-1)/2) to X = W'W (B, K, K), logJ (B,) with the VecCorr
diagonal-coefficient term, log diag W (B, K), and the upper factor W
(B, K, K) when `want_w` (else None), which the backward of the inverse
link uses. `lkj_logdet(y, K, chol)` (`lkj_logdet_pallas`) gives logJ and
log diag W alone, without forming W or X: `chol=False` with the VecCorr
term, `chol=True` the Cholesky variant's logJ (no diagonal coefficients;
its launches are counted as `lkj_logdet_chol`).
For a CUDA tensor each launches its kernel (`csrc/lkj_inv.cu`,
`csrc/lkj_logdet.cu`) or raises; for a CPU tensor it runs its plain
version. y may be any 2-D strided view (read in place), so the swapped
view of a transposed (P, B) state needs no copy (the TPU kernels'
`pre_t`). The inverse kernel keeps one element's factor in shared memory
and takes K <= MAX_K; beyond it `lkj_inverse` raises off the CPU.

The plain versions' masked cumulative sums live here, beside the kernels
they define; `bijectors/corr.py` builds the bijector on them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..utils import logcosh, pd_from_upper, vec_to_triu

# the inverse kernel's K: one element's factor, K(K+1)/2 floats (227812
# bytes at K = 337), within the 232448 bytes of shared memory a block may
# use on the H100
MAX_K = 337


@lru_cache(maxsize=None)
def _tri_masks(K, device):
    """(strict upper, upper) boolean (K, K) masks on `device`, made once."""
    ones = torch.ones(K, K, dtype=torch.bool, device=device)
    return torch.triu(ones, 1), torch.triu(ones)


def _up_mask(K, like):
    return _tri_masks(K, like.device)[0]


def _inv_link_chol_lkj_with_logdiag(Y):
    """(W, logJ, log diag W) from the strict-upper y-matrix (corr.jl:344-399:
    z = tanh(y), lc = logcosh(y), lr_incl[i,j] = -sum_{k<=i} lc[k,j],
    lr_excl = lr_incl + lc, W[i,j] = z exp(lr_excl) above the diagonal and
    W[j,j] = exp(lr_incl[j-1,j])). The log-diagonal comes straight from the
    running sums, never log(exp(.)): at |y| ~ 1e10 the diagonal underflows
    to 0 and its log would be -inf."""
    K = Y.shape[-1]
    up = _up_mask(K, Y)
    zero = torch.zeros_like(Y)
    Yu = torch.where(up, Y, zero)
    z = torch.where(up, torch.tanh(Yu), zero)
    lc = torch.where(up, logcosh(Yu), zero)
    lr_incl = -torch.cumsum(lc, dim=-2)
    lr_excl = lr_incl + lc
    W_off = z * torch.exp(lr_excl)
    diag_lr = torch.cat(
        [
            Y.new_zeros(Y.shape[:-2] + (1,)),
            torch.diagonal(lr_incl[..., :-1, 1:], dim1=-2, dim2=-1),
        ],
        dim=-1,
    )
    W = torch.where(up, W_off, zero)
    W = W + torch.exp(diag_lr)[..., None, :] * torch.eye(
        K, dtype=Y.dtype, device=Y.device
    )
    logJ = torch.sum(torch.where(up, lr_incl, zero), dim=(-2, -1))
    logJ = logJ + torch.sum(diag_lr, dim=-1)
    return W, logJ, diag_lr


def _diag_coeff(K, like):
    # corr.jl:74-81: logJ += sum_j (K-1-j) log W[j,j] for j >= 1 (0-based)
    c = np.concatenate([[0.0], np.maximum(np.arange(K - 2, -1, -1), 0)])
    return torch.as_tensor(c, dtype=like.dtype, device=like.device)


def lkj_inverse_plain(y, K: int, want_w: bool = False):
    """The plain PyTorch version (the masked cumulative sums above)."""
    W, logJ, log_diag = _inv_link_chol_lkj_with_logdiag(vec_to_triu(y, 1, K))
    logJ = logJ + torch.sum(_diag_coeff(K, y) * log_diag, dim=-1)
    return pd_from_upper(W), logJ, log_diag, (W if want_w else None)


def lkj_logdet_plain(y, K: int, chol: bool = False):
    """The plain PyTorch version of `lkj_logdet`: the masked cumulative
    sums of `lkj_inverse_plain`, with the VecCorr diagonal term unless
    `chol` (the Cholesky variant's logJ, corr.jl:485-501, is the sum of
    the running sums alone)."""
    _, logJ, log_diag = _inv_link_chol_lkj_with_logdiag(vec_to_triu(y, 1, K))
    if not chol:
        logJ = logJ + torch.sum(_diag_coeff(K, y) * log_diag, dim=-1)
    return logJ, log_diag


def _check_cuda(y, K):
    if y.dtype != torch.float32:
        raise TypeError(f"the LKJ kernels take float32; got {y.dtype}")
    if y.ndim != 2 or y.shape[1] != K * (K - 1) // 2:
        raise ValueError(f"y must be (B, {K * (K - 1) // 2}); got {tuple(y.shape)}")


def _empty(shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _fake_logdet(y, K, chol):
    return _empty((y.shape[0],), y), _empty((y.shape[0], K), y)


@kernels.kernel_op("lkj_logdet", "(Tensor y, int K, bool chol) -> (Tensor, Tensor)",
                   _fake_logdet)
def _logdet_launch(y, K, chol):
    """#5 on the card."""
    B = y.shape[0]
    logJ, log_diag = _fake_logdet(y, K, chol)
    kernels.launch(
        "tbt_lkj_logdet", "lkj_logdet_chol" if chol else "lkj_logdet", y.device,
        y.data_ptr(), y.stride(0), y.stride(1), logJ.data_ptr(), log_diag.data_ptr(),
        K, int(chol), B,
    )
    return logJ, log_diag


def lkj_logdet(y, K: int, chol: bool = False):
    """(logJ (B,), log diag W (B, K)) from y (B, K(K-1)/2)."""
    if y.device.type == "cpu":
        return lkj_logdet_plain(y, K, chol)
    _check_cuda(y, K)
    return _logdet_launch(y, K, chol)


def _fake_inverse(y, K, want_w):
    B = y.shape[0]
    return (_empty((B, K, K), y), _empty((B,), y), _empty((B, K), y),
            _empty((B, K, K) if want_w else (0,), y))


@kernels.kernel_op("lkj_inverse", "(Tensor y, int K, bool want_w) -> (Tensor, Tensor, Tensor, Tensor)",
                   _fake_inverse)
def _inverse_launch(y, K, want_w):
    """#6 on the card: (X, logJ, log diag W, W or an empty (0,))."""
    B = y.shape[0]
    X, logJ, log_diag, W = _fake_inverse(y, K, want_w)
    kernels.launch(
        "tbt_lkj_inverse", "lkj_inverse", y.device,
        y.data_ptr(), y.stride(0), y.stride(1), X.data_ptr(), logJ.data_ptr(),
        log_diag.data_ptr(), W.data_ptr() if want_w else None, K, B,
    )
    return X, logJ, log_diag, W


def lkj_inverse(y, K: int, want_w: bool = False):
    """(X (B, K, K), logJ (B,), log diag W (B, K), W (B, K, K) or None)."""
    if y.device.type == "cpu":
        return lkj_inverse_plain(y, K, want_w)
    if K > MAX_K:
        raise NotImplementedError(
            f"the LKJ inverse kernel takes K <= {MAX_K}; got K = {K} on {y.device}"
        )
    _check_cuda(y, K)
    X, logJ, log_diag, W = _inverse_launch(y, K, want_w)
    return X, logJ, log_diag, (W if want_w else None)
