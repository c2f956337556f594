"""MCMC diagnostics, PyTorch port's counterpart of the MCMC part of
`tpu_bijectors/diagnostics.py`: split-R-hat, rank-normalized R-hat, bulk
ESS and the Monte-Carlo standard error of the mean (Vehtari et al. 2021).

Computed on the host with numpy and scipy, as in the JAX package: a
diagnostic, not a hot path. `samples` is (draws, chains, ...), a numpy
array or a tensor on any device.
"""

from __future__ import annotations

import numpy as np


def _host(samples):
    if hasattr(samples, "detach"):
        samples = samples.detach().cpu().numpy()
    return np.asarray(samples)


def split_rhat(samples):
    """Split-R-hat. samples: (draws, chains, ...) -> R-hat per parameter."""
    x = _host(samples)
    n = x.shape[0]
    half = n // 2
    x = np.concatenate([x[:half], x[half : 2 * half]], axis=1)  # (half, 2m, ...)
    nn = x.shape[0]
    chain_mean = np.mean(x, axis=0)
    chain_var = np.var(x, axis=0, ddof=1)
    between = nn * np.var(chain_mean, axis=0, ddof=1)
    within = np.mean(chain_var, axis=0)
    est = (nn - 1) / nn * within + between / nn
    return np.sqrt(est / within)


def _per_param(samples, fn):
    x = _host(samples)
    n, m = x.shape[0], x.shape[1]
    flat_shape = x.shape[2:]
    x = x.reshape(n, m, -1)
    out = np.array([fn(x[:, :, j]) for j in range(x.shape[-1])], dtype=np.float64)
    return out.reshape(flat_shape) if flat_shape else float(out[0])


def ess_bulk(samples):
    """Bulk ESS via Geyer's initial monotone sequence on rank-normalized
    draws. samples: (draws, chains, ...) -> ESS per parameter."""
    return _per_param(samples, lambda col: _ess_1d(_rank_normalize(col)))


def rhat(samples):
    """Rank-normalized folded split-R-hat: the max of split-R-hat on
    rank-normalized draws (location) and on rank-normalized |x - median|
    (scale). samples: (draws, chains, ...) -> R-hat per parameter."""

    def one(col):
        z = _rank_normalize(col)
        zf = _rank_normalize(np.abs(col - np.median(col)))
        return max(float(split_rhat(z[:, :, None])[0]), float(split_rhat(zf[:, :, None])[0]))

    return _per_param(samples, one)


def mcse_mean(samples):
    """Monte-Carlo standard error of the posterior mean: sd / sqrt(ess_bulk).
    samples: (draws, chains, ...) -> MCSE per parameter."""
    x = _host(samples)
    sd = x.reshape(x.shape[0] * x.shape[1], -1).std(0, ddof=1)
    ess = np.asarray(ess_bulk(x)).reshape(-1)
    out = sd / np.sqrt(np.maximum(ess, 1.0))
    return out.reshape(x.shape[2:]) if x.ndim > 2 else float(out[0])


def _rank_normalize(x):
    from scipy.stats import norm, rankdata

    n, m = x.shape
    # average ranks for ties (indicator columns are almost all ties)
    r = rankdata(x, axis=None).reshape(x.shape)
    u = (r - 0.375) / (n * m + 0.25)
    return norm.ppf(u)


def _ess_1d(x):
    """Multi-chain ESS (Vehtari et al. 2021 / Stan). x: (draws, chains)."""
    n, m = x.shape
    chain_means = x.mean(axis=0)
    xc = x - chain_means
    # per-chain autocovariance via FFT
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].real / n  # (n, m)
    W = float((acov[0] * n / (n - 1.0)).mean())  # mean within-chain variance
    B_over_n = float(chain_means.var(ddof=1)) if m > 1 else 0.0
    var_plus = W * (n - 1.0) / n + B_over_n
    if var_plus <= 0:
        return float(n * m)
    rho = 1.0 - (W - acov.mean(axis=1)) / var_plus  # rho[t], t = 0..n-1
    # Geyer: Gamma_k = rho_{2k} + rho_{2k+1}; truncate at the first negative
    # pair, enforce monotone non-increasing; tau = 2 * sum(Gamma) - 1.
    gamma_sum = 0.0
    prev = np.inf
    k = 0
    while 2 * k + 1 < n:
        g = rho[2 * k] + rho[2 * k + 1]
        if g < 0:
            break
        g = min(g, prev)
        prev = g
        gamma_sum += g
        k += 1
    tau = max(2.0 * gamma_sum - 1.0, 1.0 / np.log10(n * m + 10.0))
    return float(n * m / tau)
