"""PSIS-LOO cross-validation and WAIC (Vehtari, Gelman & Gabry 2017),
PyTorch counterpart of `tpu_bijectors/infer/loo.py`.

The input is the pointwise log-likelihood matrix ll[s, i] = log p(y_i |
theta_s), computed from any sampler's draws, so the API is a pure tensor
transform. The Pareto-smoothed importance weights use the Zhang & Stephens
(2009) profile-posterior GPD fit, batched over observations: each one's
tail is a fixed-size slice of one sort along the draws, the grid's profile
likelihood one broadcast, and the smoothed tail the fitted GPD's expected
order statistics. `pareto_k` flags observations whose importance
distribution is too heavy-tailed to trust (k > 0.7).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LOOResult(NamedTuple):
    elpd_loo: torch.Tensor  # expected log pointwise predictive density (sum)
    se: torch.Tensor  # standard error of elpd_loo
    p_loo: torch.Tensor  # effective number of parameters
    pointwise: torch.Tensor  # (n_obs,) per-observation elpd contributions
    pareto_k: torch.Tensor  # (n_obs,) GPD shape diagnostics (k > 0.7 = bad)


class WAICResult(NamedTuple):
    elpd_waic: torch.Tensor
    se: torch.Tensor
    p_waic: torch.Tensor
    pointwise: torch.Tensor


def fit_gpd(y):
    """Generalized-Pareto (k, sigma) fit to exceedances y >= 0 on the last
    axis (leading axes are a batch of fits), by the Zhang & Stephens (2009)
    profile posterior: a closed-form grid, no optimiser. k is the tail
    index xi (cdf 1 - (1 + k y / sigma)^(-1/k), k > 0 a heavy tail), pulled
    toward 0.5 with a weak prior of weight 10 (ArviZ's stabilisation)."""
    y = torch.sort(y, dim=-1).values
    n = y.shape[-1]
    m = 30 + math.isqrt(n)
    q1 = y[..., (n + 2) // 4]  # about the first quartile's exceedance
    jgrid = torch.arange(1, m + 1, dtype=y.dtype, device=y.device)
    # candidate b values (ZS2009 eq. 7); b < 1 / y_max
    b = (1.0 / y[..., -1:]) + (1.0 - torch.sqrt(m / (jgrid - 0.5))) / (3.0 * q1[..., None])
    # profile log likelihood at each b: ZS shape k_zs = -xi there
    kzs_grid = -torch.mean(torch.log1p(-b[..., :, None] * y[..., None, :]), dim=-1)
    prof = n * (torch.log(b / kzs_grid) + kzs_grid - 1.0)
    w = torch.softmax(prof, dim=-1)
    b_hat = torch.sum(w * b, dim=-1)
    kzs = -torch.mean(torch.log1p(-b_hat[..., None] * y), dim=-1)
    sigma_hat = kzs / b_hat
    xi = (n * (-kzs) + 10 * 0.5) / (n + 10)
    return xi, sigma_hat


def _gpd_quantile(p, k, sigma):
    """(sigma / k)((1 - p)^-k - 1), its exponential limit at k -> 0."""
    small = torch.abs(k) < 1e-8
    ksafe = torch.where(small, torch.ones_like(k), k)
    return torch.where(small, -sigma * torch.log1p(-p),
                       sigma * torch.expm1(-ksafe * torch.log1p(-p)) / ksafe)


def _lpd(ll):
    """log mean_s exp(ll[s, i]) (n_obs,)."""
    return torch.logsumexp(ll, dim=0) - math.log(ll.shape[0])


def psis_loo(ll) -> LOOResult:
    """ll: (n_draws, n_obs) pointwise log likelihood. Importance ratios
    r_s ~ 1 / p(y_i | theta_s); the largest M = min(n/5, 3 sqrt(n)) of
    each observation's are replaced by the fitted GPD's expected order
    statistics (capped at the raw maximum), then elpd_i = log sum w p /
    sum w."""
    s, n_obs = ll.shape
    m = int(min(s / 5.0, 3.0 * s**0.5))
    if m < 5:
        raise ValueError(f"too few draws ({s}) for PSIS tail fitting")
    logr = -ll.T  # (n_obs, s) unnormalised log importance ratios
    srt, idx = torch.sort(logr, dim=-1, stable=True)
    cutoff = srt[:, -m - 1 : -m]
    tail = srt[:, -m:]
    mx = tail[:, -1:]
    # exceedances on the exp scale, relative to the cutoff, stabilised by
    # the tail's max
    exc = torch.exp(tail - mx) - torch.exp(cutoff - mx)
    k_hat, sigma = fit_gpd(exc)
    p = (torch.arange(1, m + 1, dtype=ll.dtype, device=ll.device) - 0.5) / m
    smooth = torch.log(_gpd_quantile(p, k_hat[:, None], sigma[:, None])
                       + torch.exp(cutoff - mx)) + mx
    smooth = torch.minimum(smooth, mx)
    new_sorted = torch.cat([srt[:, :-m], smooth], dim=-1)
    lw = torch.zeros_like(logr).scatter(-1, idx, new_sorted).T
    elpd_i = torch.logsumexp(lw + ll, dim=0) - torch.logsumexp(lw, dim=0)
    p_loo = torch.sum(_lpd(ll) - elpd_i)
    se = torch.sqrt(n_obs * torch.var(elpd_i))
    return LOOResult(torch.sum(elpd_i), se, p_loo, elpd_i, k_hat)


def waic(ll) -> WAICResult:
    """ll: (n_draws, n_obs). elpd_waic = sum_i [lpd_i - var_s(ll_si)]."""
    n_obs = ll.shape[1]
    p_i = torch.var(ll, dim=0)
    elpd_i = _lpd(ll) - p_i
    return WAICResult(torch.sum(elpd_i), torch.sqrt(n_obs * torch.var(elpd_i)),
                      torch.sum(p_i), elpd_i)
