"""Hand-derived Jacobian oracles of the reference, the port's own copy
of `tpu_bijectors/testing/oracles.py`.

The reference ships dense simplex Jacobians used both as ReverseDiff
adjoints and as test oracles (src/bijectors/simplex.jl:217-352; the
`J_link @ J_invlink = I` golden test is test/legacy_interface.jl:299-312).
Here they serve the oracle role only (autograd differentiates the actual
links), so they are plain float64 numpy, loop-form on purpose (independent
of the vectorized implementations they check).
"""

from __future__ import annotations

import numpy as np

_EPS = np.finfo(np.float64).eps


def _logistic(v):
    return 1.0 / (1.0 + np.exp(-v))


def simplex_link_jacobian(x: np.ndarray) -> np.ndarray:
    """d y / d x of the stick-breaking link, shape (K-1, K)
    (reference simplex_link_jacobian, simplex.jl:217-239)."""
    x = np.asarray(x, np.float64)
    K = x.shape[0]
    assert K > 1
    J = np.zeros((K, K - 1))
    eps = _EPS
    z = x[0] * (1 - 2 * eps) + eps
    J[0, 0] = (1 / z + 1 / (1 - z)) * (1 - 2 * eps)
    sum_tmp = 0.0
    for k in range(1, K - 1):
        sum_tmp += x[k - 1]
        z = (x[k] + eps) * (1 - 2 * eps) / ((1 + eps) - sum_tmp)
        J[k, k] = (1 / z + 1 / (1 - z)) * (1 - 2 * eps) / ((1 + eps) - sum_tmp)
        for i in range(k):
            J[i, k] = (
                (1 / z + 1 / (1 - z))
                * (x[k] + eps)
                * (1 - 2 * eps)
                / ((1 + eps) - sum_tmp) ** 2
            )
    return J.T  # (K-1, K): row = y index, column = x index


def simplex_invlink_jacobian(y: np.ndarray) -> np.ndarray:
    """d x / d y of the stick-breaking inverse, shape (K, K-1), with the
    clamp gating of the reference (simplex_invlink_jacobian,
    simplex.jl:311-352)."""
    y = np.asarray(y, np.float64)
    K = y.shape[0] + 1
    J = np.zeros((K, K - 1))
    eps = _EPS
    z = _logistic(y[0] - np.log(K - 1.0))
    unclamped = (z - eps) / (1 - 2 * eps)
    clamped = min(max(unclamped, 0.0), 1.0)
    if unclamped == clamped:
        J[0, 0] = z * (1 - z) / (1 - 2 * eps)
    sum_tmp = 0.0
    for k in range(1, K - 1):
        z = _logistic(y[k] - np.log(K - 1.0 - k))
        sum_tmp += clamped
        unclamped = ((1 + eps) - sum_tmp) / (1 - 2 * eps) * z - eps
        clamped = min(max(unclamped, 0.0), 1.0)
        if unclamped == clamped:
            J[k, k] = z * (1 - z) * ((1 + eps) - sum_tmp) / (1 - 2 * eps)
            for i in range(k):
                for j in range(i, k):
                    J[k, i] += -J[j, i] * z / (1 - 2 * eps)
    sum_tmp += clamped
    unclamped = 1.0 - sum_tmp
    clamped = min(max(unclamped, 0.0), 1.0)
    if unclamped == clamped:
        for i in range(K - 1):
            for j in range(i, K - 1):
                J[K - 1, i] += -J[j, i]
    return J


# ---------------------------------------------------------------------------
# Ordered-bijector pullbacks (reference ext/BijectorsChainRulesCoreExt.jl:65-197)
# ---------------------------------------------------------------------------


def ordered_forward_vjp(y: np.ndarray, dx: np.ndarray) -> np.ndarray:
    """VJP of the ordered forward x = cumsum([y0, exp(y1), ...]) at cotangent
    dx (reference rrule for `_transform_ordered`,
    ext/BijectorsChainRulesCoreExt.jl:65-90):
      dy[0] = sum(dx);  dy[i] = sum(dx[i:]) * exp(y[i])."""
    y = np.asarray(y, np.float64)
    dx = np.asarray(dx, np.float64)
    n = y.shape[0]
    dy = np.empty(n)
    s = dx.sum()
    dy[0] = s
    for i in range(1, n):
        s -= dx[i - 1]
        dy[i] = s * np.exp(y[i])
    return dy


def ordered_inverse_vjp(x: np.ndarray, dy: np.ndarray) -> np.ndarray:
    """VJP of the ordered inverse y = [x0, log(diff(x))] at cotangent dy
    (reference rrule for `_transform_inverse_ordered`,
    ext/BijectorsChainRulesCoreExt.jl:119-153):
      r[0] = 1, r[i] = x[i] - x[i-1];
      dx[j] = dy[j]/r[j] - dy[j+1]/r[j+1]  (j < n-1);  dx[n-1] = dy[n-1]/r[n-1]."""
    x = np.asarray(x, np.float64)
    dy = np.asarray(dy, np.float64)
    n = x.shape[0]
    r = np.empty(n)
    r[0] = 1.0
    r[1:] = x[1:] - x[:-1]
    dx = np.empty(n)
    for j in range(n - 1):
        dx[j] = dy[j] / r[j] - dy[j + 1] / r[j + 1]
    dx[n - 1] = dy[n - 1] / r[n - 1]
    return dx


# ---------------------------------------------------------------------------
# LKJ (Cholesky) link pullbacks
# (reference src/bijectors/corr.jl:402-462 `_inv_link_chol_lkj_rrule` and
#  ext/BijectorsChainRulesCoreExt.jl:199-255 `_link_chol_lkj_from_upper`)
# All vectors use the COLUMN-MAJOR strict-upper packing of utils.triu_to_vec
# (identical to the reference's `_triu_to_vec`, src/utils.jl:67-87).
# ---------------------------------------------------------------------------


def _triu1_dim(d: int) -> int:
    n = int((1 + np.sqrt(1 + 8 * d)) // 2)
    assert n * (n - 1) // 2 == d
    return n


def lkj_invlink_with_vjp(y_vec: np.ndarray):
    """Chol-variant inverse link y_vec -> (W upper (K,K), logJ) plus its VJP
    closure (dW, dlogJ) -> dy_vec. Loop-form port of the reference's
    hand-derived reverse rule (corr.jl:402-451)."""
    y = np.asarray(y_vec, np.float64)
    K = _triu1_dim(y.shape[0])
    z = np.tanh(y)
    lc = np.log(np.cosh(y)) + np.zeros_like(y)  # logcosh; y is O(1) in tests

    W = np.zeros((K, K))
    W[0, 0] = 1.0
    logJ = 0.0
    idx = 0
    for j in range(1, K):
        log_rem = 0.0
        for i in range(j):
            W[i, j] = z[idx] * np.exp(log_rem)
            log_rem -= lc[idx]
            logJ += log_rem
            idx += 1
        logJ += log_rem
        W[j, j] = np.exp(log_rem)

    def vjp(dW, dlogJ):
        dW = np.asarray(dW, np.float64)
        dlogJ = float(dlogJ)
        dy = np.zeros_like(y)
        idx_l = y.shape[0] - 1
        for j in range(K - 1, 0, -1):
            dlog_rem = W[j, j] * dW[j, j] + 2.0 * dlogJ
            for i in range(j - 1, -1, -1):
                W_dW = W[i, j] * dW[i, j]
                zv = z[idx_l]
                dy[idx_l] = (1.0 / zv - zv) * W_dW - zv * dlog_rem
                idx_l -= 1
                dlog_rem += dlogJ + W_dW
        return dy

    return (W, logJ), vjp


def lkj_link_from_upper_vjp(W: np.ndarray, dz: np.ndarray) -> np.ndarray:
    """VJP of the forward link W (upper-tri Cholesky factor) -> z_vec
    (atanh first row, asinh below; column-major packing) at cotangent dz.
    Loop-form port of the reference's hand-derived rule
    (ext/BijectorsChainRulesCoreExt.jl:199-255)."""
    W = np.asarray(W, np.float64)
    dz = np.asarray(dz, np.float64)
    K = W.shape[0]
    N = (K - 1) * K // 2

    remainders = np.zeros(N)
    # forward sweep recording the partial column remainders
    starting_idx = 0  # 0-based position of column j's first (atanh) slot
    for j in range(1, K):
        remainder_sq = W[j, j] ** 2
        col_len = j
        for i in range(j - 1, 0, -1):
            idx = starting_idx + i  # slot of row i within this column block
            remainders[idx] = np.sqrt(remainder_sq)
            remainder_sq += W[i, j] ** 2
        remainders[starting_idx] = np.sqrt(remainder_sq)
        starting_idx += col_len

    dW = np.zeros_like(W)
    for j in range(1, K):
        idx_prev = j * (j - 1) // 2  # slots before this column
        dtmp = 0.0
        for i in range(j - 1, 0, -1):
            # slot i-1 holds the remainder EXCLUDING row i-1, i.e. the one
            # INCLUDING row i — so p = W/r_incl = tanh(z) stays in (-1, 1)
            tmp = remainders[idx_prev + i - 1]
            p = W[i, j] / tmp
            ftmp = np.sqrt(1.0 - p * p)
            d_ftmp_p = -p / ftmp
            d_p_tmp = -W[i, j] / (tmp * tmp)
            dp = dz[idx_prev + i] / (1.0 - p * p) + dtmp * tmp * d_ftmp_p
            dW[i, j] = dp / tmp
            dtmp = dp * d_p_tmp + dtmp * ftmp
        dW[0, j] = dz[idx_prev] / (1.0 - W[0, j] ** 2) - dtmp * W[0, j] / np.sqrt(
            1.0 - W[0, j] ** 2
        )
    return dW
