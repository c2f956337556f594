"""Pathfinder variational inference (Zhang, Carpenter, Gelman & Vehtari,
JMLR 23(306), 2022) on the flat unconstrained vector, PyTorch counterpart
of `tpu_bijectors/infer/pathfinder.py`.

L-BFGS runs toward the mode (`lbfgs.py`); every iterate's compact
inverse-Hessian estimate Sigma_k = diag(alpha) + beta gamma beta' (Byrd,
Nocedal & Schnabel 1994) gives a local Gaussian N(theta_k - Sigma_k
grad loss(theta_k), Sigma_k), each candidate's ELBO is estimated by Monte
Carlo, and the best is kept. Multi-path pools several runs by truncated
importance resampling.

The JAX package's two scans are host loops here: the optimiser's (one
density evaluation at a batch of one a line-search trial) and the history's
over fixed-size (J, dim) buffers with a validity mask, updated by `where`
on the device (no read). The candidates are one batched computation over
the iterates (thin QR of the (dim, 2J) factor, Cholesky of a 2J x 2J
core), and every candidate's ELBO draws go through ONE batch-major density
call (`as_batched`): max_iters x n_elbo_mc rows, and for multi-path every
path's at once. The paths of `multipath_pathfinder` run one after another
where the JAX package vmaps them: equal in distribution.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .map_laplace import _loss_value_and_grad, _run_optimizer
from .model import as_batched

_LOG2PI = math.log(2.0 * math.pi)
_CURV_EPS = 1e-12  # accept a pair iff s'z > eps |z|^2 (Stan's condition)


class PathfinderResult(NamedTuple):
    position: torch.Tensor  # (dim,) mean of the ELBO-best candidate Gaussian
    draws: torch.Tensor  # (n_draws, dim) from the best candidate
    logq: torch.Tensor  # (n_draws,) candidate log density of each draw
    logp: torch.Tensor  # (n_draws,) target log density of each draw
    elbo: torch.Tensor  # (max_iters,) per-candidate ELBO estimates
    best: torch.Tensor  # argmax index into elbo
    alpha: torch.Tensor  # (dim,) diagonal of the best candidate's Sigma
    beta: torch.Tensor  # (dim, 2J) low-rank factor
    gamma: torch.Tensor  # (2J, 2J) core; Sigma = diag(alpha) + beta gamma beta'


def _mT(a):
    return a.transpose(-1, -2)


def _alpha_update(alpha, s, z):
    """The diagonal inverse-Hessian estimate's update (paper Alg. 2, the
    Gilbert-Lemarechal scaling Stan uses)."""
    a = torch.sum(z * z * alpha, dim=-1, keepdim=True)
    b = torch.sum(z * s, dim=-1, keepdim=True)
    c = torch.sum(s * s / alpha, dim=-1, keepdim=True)
    inv = a / (b * alpha) + z * z / b - (a * s * s) / (b * c * alpha * alpha)
    return torch.clamp(1.0 / inv, 1e-12, 1e12)


def _factors(S, Z, mask, alpha):
    """Compact-representation factors (beta (..., dim, 2J), gamma (..., 2J,
    2J)) of Sigma = diag(alpha) + beta gamma beta' from the (..., J, dim)
    pair buffers (oldest to newest) and their validity mask (..., J).
    Masked slots carry zero rows, so their beta columns are zero; R gets
    a unit diagonal there to stay invertible (Byrd-Nocedal-Schnabel 1994
    eq. 4.7; paper Lemma 1)."""
    m = mask.to(alpha.dtype)
    S = S * m[..., :, None]
    Z = Z * m[..., :, None]
    sz = S @ _mT(Z)  # sz[i, j] = s_i' z_j
    j = sz.shape[-1]
    eye = torch.eye(j, dtype=alpha.dtype, device=alpha.device)
    r = torch.triu(sz) + torch.diag_embed(1.0 - m)
    e = torch.diag_embed(torch.diagonal(sz, dim1=-2, dim2=-1))
    zaz = Z @ _mT(alpha[..., None, :] * Z)
    rinv = torch.linalg.solve_triangular(r, eye.expand_as(r), upper=True)
    top_left = _mT(rinv) @ (e + zaz) @ rinv
    gamma = torch.cat([torch.cat([top_left, -_mT(rinv)], dim=-1),
                       torch.cat([-rinv, torch.zeros_like(rinv)], dim=-1)], dim=-2)
    beta = torch.cat([_mT(S), alpha[..., :, None] * _mT(Z)], dim=-1)
    return beta, gamma


def _sigma_mv(alpha, beta, gamma, g):
    """Sigma g for g (..., dim)."""
    return alpha * g + (beta @ (gamma @ (_mT(beta) @ g[..., None])))[..., 0]


def _sqrt_pieces(alpha, beta, gamma):
    """Thin QR and a small Cholesky giving the Sigma^1/2 action and half
    log|Sigma| (paper Alg. 4): with Q R = qr(diag(alpha)^-1/2 beta) and
    L = chol(I + R gamma R'), Sigma^1/2 = diag(alpha^1/2)(Q L Q' + I - QQ')."""
    qbar = beta / torch.sqrt(alpha)[..., :, None]
    q, rt = torch.linalg.qr(qbar, mode="reduced")
    mm = rt.shape[-2]
    core = torch.eye(mm, dtype=alpha.dtype, device=alpha.device) + rt @ gamma @ _mT(rt)
    core = 0.5 * (core + _mT(core))
    ell, info = torch.linalg.cholesky_ex(core)
    ell = torch.where(info[..., None, None] == 0, ell, torch.full_like(ell, math.nan))
    half_logdet = 0.5 * torch.sum(torch.log(alpha), dim=-1) + torch.sum(
        torch.log(torch.diagonal(ell, dim1=-2, dim2=-1)), dim=-1)
    return q, ell, half_logdet


def _logq(x, mu, alpha, q, ell, half_logdet):
    """log q(x) of points x (..., n, dim) under N(mu, Sigma) in the
    factored form (mu, alpha: (..., dim); q, ell, half_logdet per
    candidate)."""
    dim = mu.shape[-1]
    xi = (x - mu[..., None, :]) / torch.sqrt(alpha)[..., None, :]
    xq = xi @ q
    w = _mT(torch.linalg.solve_triangular(ell, _mT(xq), upper=False))
    quad = torch.sum(w * w, -1) + torch.sum(xi * xi, -1) - torch.sum(xq * xq, -1)
    return -0.5 * quad - half_logdet[..., None] - 0.5 * dim * _LOG2PI


def _sample_and_logq(u, mu, alpha, beta, gamma):
    """Draws x = mu + Sigma^1/2 u of standard normals u (..., n, dim) and
    their log q(x), through the factors (no dense matrix is formed)."""
    q, ell, half_logdet = _sqrt_pieces(alpha, beta, gamma)
    uq = u @ q
    x = mu[..., None, :] + torch.sqrt(alpha)[..., None, :] * (
        uq @ _mT(ell) @ _mT(q) + u - uq @ _mT(q))
    return x, _logq(x, mu, alpha, q, ell, half_logdet)


def _history(thetas, grads, history: int):
    """The rolling curvature-pair history after each of the L steps:
    (S_all, Z_all (L, J, dim), mask_all (L, J), alpha_all (L, dim)), each
    the state after absorbing pair k, the one candidate k + 1 is built
    from. A host loop over the pairs; acceptance is a `where` on the
    device."""
    s_seq = thetas[1:] - thetas[:-1]
    z_seq = grads[1:] - grads[:-1]
    dim = thetas.shape[-1]
    S = thetas.new_zeros((history, dim))
    Z = thetas.new_zeros((history, dim))
    mask = torch.zeros(history, dtype=torch.bool, device=thetas.device)
    alpha = thetas.new_ones((dim,))
    out = ([], [], [], [])
    for s, z in zip(s_seq, z_seq):
        ok = torch.sum(s * z) > _CURV_EPS * torch.sum(z * z)
        alpha = torch.where(ok, _alpha_update(alpha, s, z), alpha)
        S = torch.where(ok, torch.cat([S[1:], s[None]]), S)
        Z = torch.where(ok, torch.cat([Z[1:], z[None]]), Z)
        mask = torch.where(ok, torch.cat([mask[1:], mask.new_ones((1,))]), mask)
        for acc, t in zip(out, (S, Z, mask, alpha)):
            acc.append(t)
    return tuple(torch.stack(t) for t in out)


def _candidates(thetas, grads, S_all, Z_all, mask_all, alpha_all, u):
    """Every candidate's mean and ELBO draws with their log q, given the
    standard normals u (L, M, dim): (mus (L, dim), xs (L, M, dim), logqs
    (L, M))."""
    beta, gamma = _factors(S_all, Z_all, mask_all, alpha_all)
    mus = thetas - _sigma_mv(alpha_all, beta, gamma, grads)
    xs, logqs = _sample_and_logq(u, mus, alpha_all, beta, gamma)
    return mus, xs, logqs


def _elbo(logps, logqs):
    """Per-candidate ELBO (L,) of the target and candidate log densities
    (L, M); a non-finite target value counts as -inf."""
    terms = torch.where(torch.isfinite(logps), logps, torch.full_like(logps, -math.inf)) - logqs
    elbo = torch.mean(terms, dim=-1)
    return torch.where(torch.isfinite(elbo), elbo, torch.full_like(elbo, -math.inf))


class _Path(NamedTuple):
    """One path's optimisation and candidates, before any density call."""

    history: tuple  # (S_all, Z_all, mask_all, alpha_all)
    mus: torch.Tensor
    xs: torch.Tensor
    logqs: torch.Tensor


def _run_path(logdensity_fn, normal, v0, max_iters, history, n_elbo_mc, optimizer):
    """L-BFGS (or `optimizer`) for max_iters steps from v0, the pair
    history, and every candidate's ELBO draws from the standard normals
    `normal(shape)` gives."""
    vg = _loss_value_and_grad(logdensity_fn)
    vs, _, gs, v_last = _run_optimizer(vg, v0, max_iters, optimizer)
    g_last = vg(v_last)[1]
    thetas = torch.cat([vs, v_last[None]])
    grads = torch.cat([gs, g_last[None]])
    hist = _history(thetas, grads, history)
    u = normal((max_iters, n_elbo_mc, v0.shape[-1]))
    mus, xs, logqs = _candidates(thetas[1:], grads[1:], *hist, u)
    return _Path(hist, mus, xs, logqs)


def _best_draws(path, elbo, normal, n_draws):
    """The ELBO-best candidate's (best, mu, alpha, beta, gamma) and n_draws
    draws from it with their log q."""
    best = torch.argmax(elbo)
    S, Z, mask, alpha = (torch.index_select(t, 0, best[None])[0] for t in path.history)
    beta, gamma = _factors(S, Z, mask, alpha)
    mu = torch.index_select(path.mus, 0, best[None])[0]
    u = normal((n_draws, mu.shape[-1]))
    draws, logq = _sample_and_logq(u, mu, alpha, beta, gamma)
    return best, mu, alpha, beta, gamma, draws, logq


def _normal(generator, like):
    """Standard normals of a shape from `generator`, in like's dtype and
    device."""
    return lambda shape: torch.randn(shape, generator=generator, dtype=like.dtype,
                                     device=like.device)


def _results(logdensity_fn, normal, v0s, max_iters, history, n_elbo_mc, n_draws, optimizer):
    """The PathfinderResult of each path from the starts v0s (P, dim), the
    draws from `normal(shape)`: the paths one after another, then one
    density call over every path's ELBO draws and one over every path's
    final draws."""
    blogp = as_batched(logdensity_fn)
    paths = [_run_path(logdensity_fn, normal, v0, max_iters, history, n_elbo_mc, optimizer)
             for v0 in v0s]
    dim = v0s.shape[-1]
    xs = torch.stack([p.xs for p in paths]).reshape(-1, dim)
    logps = blogp(xs).detach().reshape(len(paths), max_iters, n_elbo_mc)
    picks = [_best_draws(p, _elbo(lp, p.logqs), normal, n_draws)
             for p, lp in zip(paths, logps)]
    logp_d = blogp(torch.cat([pk[5] for pk in picks])).detach().reshape(len(paths), n_draws)
    out = []
    for p, lp, pk, lpd in zip(paths, logps, picks, logp_d):
        best, mu, alpha, beta, gamma, draws, logq = pk
        out.append(PathfinderResult(mu, draws, logq, lpd, _elbo(lp, p.logqs), best, alpha,
                                    beta, gamma))
    return out


def fit_pathfinder(logdensity_fn, generator, v0, max_iters: int = 60, history: int = 6,
                   n_elbo_mc: int = 30, n_draws: int = 100, optimizer=None) -> PathfinderResult:
    """Single-path Pathfinder from v0 (dim,). `logdensity_fn` maps (dim,),
    or where it declares batch support (B, dim), to log p; the optimiser
    evaluates it at a batch of one and the candidates' ELBO draws in one
    batched call. Every draw comes from `generator` (on v0's device).
    Returns draws from the ELBO-best candidate with its Sigma factors
    (alpha, beta, gamma seed a NUTS metric)."""
    return _results(logdensity_fn, _normal(generator, v0), v0[None], max_iters, history,
                    n_elbo_mc, n_draws, optimizer)[0]


def _truncated_log_weights(logw):
    """Importance log weights truncated at log mean(w) + half log N (Ionides
    2008); non-finite ones count as -inf."""
    logw = torch.where(torch.isfinite(logw), logw, torch.full_like(logw, -math.inf))
    n = logw.shape[0]
    log_mean_w = torch.logsumexp(logw, dim=0) - math.log(n)
    return torch.minimum(logw, log_mean_w + 0.5 * math.log(n))


def multipath_pathfinder(logdensity_fn, generator, v0s, n_draws: int = 1000,
                         per_path_draws: int = 200, max_iters: int = 60, history: int = 6,
                         n_elbo_mc: int = 30, optimizer=None):
    """Multi-path Pathfinder (paper section 5): P single paths from v0s (P,
    dim), their draws pooled with truncated importance weights and
    resampled (with replacement) down to `n_draws`. Every path's ELBO
    draws go through one density call. Returns (draws (n_draws, dim),
    results): `results` stacks each path's PathfinderResult on a leading
    P axis."""
    res = _results(logdensity_fn, _normal(generator, v0s), v0s, max_iters, history,
                   n_elbo_mc, per_path_draws, optimizer)
    res = PathfinderResult(*(torch.stack(t) for t in zip(*res)))
    pool = res.draws.reshape(-1, v0s.shape[-1])
    logw_t = _truncated_log_weights((res.logp - res.logq).reshape(-1))
    take = torch.multinomial(torch.softmax(logw_t, dim=0), n_draws, replacement=True,
                             generator=generator)
    return pool[take], res
