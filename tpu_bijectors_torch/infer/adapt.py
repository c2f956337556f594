"""Warmup adaptation, PyTorch counterpart of `tpu_bijectors/infer/adapt.py`:
dual-averaging step size, the diagonal and dense Welford mass estimates
and the Stan-style window schedule. Statistics are averaged over the chain axis of
the one process (the JAX package's `axis_name` sharing across devices is
not ported).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Dual averaging step size (Hoffman & Gelman 2014, Nesterov 2009)
# ---------------------------------------------------------------------------


class StepSizeAdaptState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    step: torch.Tensor


def stepsize_init(eps0: float, dtype=torch.float64, device="cpu") -> StepSizeAdaptState:
    t = lambda v, dt=dtype: torch.tensor(v, dtype=dt, device=device)  # noqa: E731
    return StepSizeAdaptState(
        t(math.log(eps0)), t(math.log(eps0)), t(0.0), t(math.log(10.0 * eps0)),
        t(0, torch.int32),
    )


def stepsize_update(
    s: StepSizeAdaptState,
    accept_prob,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> StepSizeAdaptState:
    t = s.step + 1
    tf = t.to(s.log_eps.dtype)
    eta_h = 1.0 / (tf + t0)
    h_bar = (1.0 - eta_h) * s.h_bar + eta_h * (target - accept_prob)
    log_eps = s.mu - torch.sqrt(tf) / gamma * h_bar
    eta = tf ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * s.log_eps_bar
    return StepSizeAdaptState(log_eps, log_eps_bar, h_bar, s.mu, t)


def stepsize_init_like(eps, ss: StepSizeAdaptState) -> StepSizeAdaptState:
    """A fresh dual-averaging state around the current step size (after a
    metric refresh, as Stan restarts it)."""
    log_eps = torch.log(eps).to(ss.log_eps.dtype)
    return StepSizeAdaptState(
        log_eps, log_eps, torch.zeros_like(ss.h_bar), math.log(10.0) + log_eps,
        torch.zeros_like(ss.step),
    )


# ---------------------------------------------------------------------------
# Welford accumulator for the diagonal mass matrix
# ---------------------------------------------------------------------------


class WelfordState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dim: int, dtype=torch.float64, device="cpu") -> WelfordState:
    return WelfordState(
        torch.tensor(0.0, dtype=dtype, device=device),
        torch.zeros(dim, dtype=dtype, device=device),
        torch.zeros(dim, dtype=dtype, device=device),
    )


def welford_update_batch(s: WelfordState, xs) -> WelfordState:
    """Fold a whole (chains, dim) batch in (Chan et al. parallel combine)."""
    mean_b = torch.mean(xs, dim=0)
    m2_b = torch.sum((xs - mean_b) ** 2, dim=0)
    n = float(xs.shape[0])
    count = s.count + n
    delta = mean_b - s.mean
    mean = s.mean + delta * (n / count)
    m2 = s.m2 + m2_b + delta * delta * (s.count * n / count)
    return WelfordState(count, mean, m2)


def welford_variance(s: WelfordState, regularize: bool = True):
    var = s.m2 / torch.clamp_min(s.count - 1.0, 1.0)
    if regularize:
        # Stan's shrinkage toward unit metric
        w = s.count / (s.count + 5.0)
        var = w * var + (1.0 - w) * 1e-3 * torch.ones_like(var)
    return var


# ---------------------------------------------------------------------------
# Welford accumulator for the dense mass matrix (Stan's dense_e metric)
# ---------------------------------------------------------------------------


def welford_cov_init(dim: int, dtype=torch.float64, device="cpu") -> WelfordState:
    """The WelfordState with a (dim, dim) m2 (sums of outer products)."""
    return WelfordState(
        torch.tensor(0.0, dtype=dtype, device=device),
        torch.zeros(dim, dtype=dtype, device=device),
        torch.zeros((dim, dim), dtype=dtype, device=device),
    )


def welford_cov_update_batch(s: WelfordState, xs) -> WelfordState:
    """Fold a (chains, dim) batch into the covariance accumulator (Chan et
    al. pairwise combine)."""
    mean_b = torch.mean(xs, dim=0)
    c = xs - mean_b
    m2_b = c.T @ c
    n = float(xs.shape[0])
    count = s.count + n
    delta = mean_b - s.mean
    mean = s.mean + delta * (n / count)
    m2 = s.m2 + m2_b + torch.outer(delta, delta) * (s.count * n / count)
    return WelfordState(count, mean, m2)


def welford_covariance(s: WelfordState, regularize: bool = True):
    cov = s.m2 / torch.clamp_min(s.count - 1.0, 1.0)
    if regularize:
        w = s.count / (s.count + 5.0)
        eye = torch.eye(s.mean.shape[-1], dtype=cov.dtype, device=cov.device)
        cov = w * cov + (1.0 - w) * 1e-3 * eye
    return cov


# ---------------------------------------------------------------------------
# Stan-style adaptation schedule (init buffer / doubling windows / term buffer)
# ---------------------------------------------------------------------------


def build_schedule(n_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                   base_window: int = 25):
    """Returns an int32 numpy array `window_id` of length n_warmup: -1
    during the init/term buffers (step-size-only), otherwise the index of
    the mass window; and a bool array `window_end` marking the last step of
    each mass window (where the mass matrix is refreshed and Welford reset).
    Host arrays: the port's warmup loop runs on the host."""
    window_id = np.full(n_warmup, -1, np.int32)
    window_end = np.zeros(n_warmup, bool)
    if n_warmup <= 0:
        return window_id, window_end
    if n_warmup < init_buffer + term_buffer + base_window:
        # too short: single window covering the middle
        lo = min(init_buffer, n_warmup // 3)
        hi = max(n_warmup - term_buffer, lo + 1)
        window_id[lo:hi] = 0
        window_end[hi - 1] = True
        return window_id, window_end
    pos = init_buffer
    w = base_window
    wid = 0
    while pos < n_warmup - term_buffer:
        end = pos + w
        if end + 2 * w > n_warmup - term_buffer:
            end = n_warmup - term_buffer  # absorb the remainder
        window_id[pos:end] = wid
        window_end[end - 1] = True
        pos = end
        w *= 2
        wid += 1
    return window_id, window_end
