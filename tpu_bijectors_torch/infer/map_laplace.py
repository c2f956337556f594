"""MAP estimation and the Laplace approximation in unconstrained space,
PyTorch counterpart of `tpu_bijectors/infer/map_laplace.py`.

Both act on the flat unconstrained vector of the vectorize layer, so every
support constraint is already removed: the optimiser runs unboxed over
R^dim and the Laplace Gaussian has full support. The mode maximises the
linked density logp(x) + logdetJ, the pushforward density the samplers
target.

The JAX package's scan over optimiser steps is a host loop here: L-BFGS
(`lbfgs.py`, the port of `optax.lbfgs()`) by default, each of its
line-search trials one evaluation of the density and its gradient at a
batch of one and one read to the host. The Hessian that the JAX package
takes with `jax.hessian` comes from one double-backward pass over a block
of dim copies of the mode through the batch-major density (`as_batched`):
row i of d(sum_i dlp(V_i)/dv_i)/dV is the gradient of dlp/dv_i, so each
link kernel runs once at B = dim, not dim times. The Cholesky factor and
triangular solves are torch.linalg calls, as the JAX package computes
them outside any kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .advi import _adam
from .lbfgs import _stack, lbfgs
from .model import as_batched

_LOG2PI = math.log(2.0 * math.pi)


class MAPResult(NamedTuple):
    position: torch.Tensor  # linked-space argmax (best iterate seen)
    logdensity: torch.Tensor  # logp at `position`
    grad_norm: torch.Tensor  # ||grad logp|| at the final iterate
    losses: torch.Tensor  # per-step negative log density


def _loss_value_and_grad(logdensity_fn):
    """(-logp(v), -grad logp(v)) of one (dim,) state: the batch-major form's
    `value_and_grad_fn` on a block of one where the density has one
    (Model.logdensity_fn), else autograd through the function."""
    blogp = as_batched(logdensity_fn)
    vg = getattr(blogp, "value_and_grad_fn", None)

    def value_and_grad(v):
        if vg is not None:
            lp, g = vg(v[None, :])
            return -lp[0], -g[0]
        with torch.enable_grad():
            vv = v.detach().requires_grad_(True)
            lp = logdensity_fn(vv)
            (g,) = torch.autograd.grad(lp, vv)
        return -lp.detach(), -g

    return value_and_grad


def _run_optimizer(value_and_grad, v0, n_steps: int, optimizer=None):
    """(iterates (n_steps, dim), losses (n_steps,), gradients (n_steps,
    dim), final iterate) of `n_steps` optimiser steps from v0, each record
    taken before its step's update: L-BFGS when `optimizer` is None, else
    the torch.optim optimiser `optimizer([v])` stepped on the loss's
    gradient."""
    if optimizer is None:
        tr = lbfgs(value_and_grad, v0, n_steps)
        return tr.positions, tr.values, tr.grads, tr.final
    v = v0.detach().clone().requires_grad_(True)
    opt = optimizer([v])
    vs, values, grads = [], [], []
    for _ in range(n_steps):
        value, g = value_and_grad(v.detach())
        vs.append(v.detach().clone())
        values.append(value)
        grads.append(g)
        v.grad = g.clone()
        opt.step()
    return _stack(vs, v0), _stack(values, v0[0]), _stack(grads, v0), v.detach()


def fit_map(logdensity_fn, v0, n_steps: int = 200, optimizer=None,
            learning_rate: float | None = None) -> MAPResult:
    """Maximise logp(v) over the flat unconstrained vector from v0 (dim,).

    The default optimiser is L-BFGS with its zoom line search (optax's
    `lbfgs()`, ported). `optimizer` is a factory that takes the list of
    parameter tensors and returns a `torch.optim` optimiser;
    `learning_rate` is a shorthand for Adam at optax.adam's defaults.

    The best iterate (not the last) is returned: a failed line search or a
    too-large Adam step can end on a worse point."""
    if optimizer is not None and learning_rate is not None:
        raise ValueError("pass either optimizer or learning_rate, not both")
    if learning_rate is not None:
        optimizer = _adam(learning_rate)
    vg = _loss_value_and_grad(logdensity_fn)
    vs, losses, _, v = _run_optimizer(vg, v0, n_steps, optimizer)
    final_loss, final_grad = vg(v)
    # the best of the recorded iterates, then the final one (recorded
    # before each update, the run never saw it): ties keep the earlier
    cand = torch.cat([losses, final_loss[None]])
    cand = torch.where(torch.isnan(cand), torch.full_like(cand, math.inf), cand)
    best = torch.argmin(cand)
    pos = torch.cat([vs, v[None]])[best]
    return MAPResult(pos, -cand[best], torch.linalg.vector_norm(final_grad), losses)


class LaplaceApprox(NamedTuple):
    """Gaussian N(mean, H^-1) in linked space, H = -hess logp(mean), held
    by the Cholesky factor of the precision (H = L L'): sampling is one
    triangular solve, the density one triangular product, and the
    evidence's half log|H| a diagonal sum."""

    mean: torch.Tensor
    chol_precision: torch.Tensor  # lower-triangular L, H = L L'
    logdensity_at_mode: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def _from_z(self, z):
        """Draws mean + L^-T z of standard normals z (n, dim)."""
        u = torch.linalg.solve_triangular(self.chol_precision.T, z.T, upper=True)
        return self.mean + u.T

    def sample(self, generator, n: int):
        """(n, dim) linked-space draws v = mean + L^-T z, z ~ N(0, I), from
        `generator`. Constrain with `model.constrain(draws)`."""
        z = torch.randn((n, self.dim), generator=generator, dtype=self.mean.dtype,
                        device=self.mean.device)
        return self._from_z(z)

    def _half_logdet_h(self):
        return torch.sum(torch.log(torch.diagonal(self.chol_precision)))

    def logdensity(self, v):
        """Gaussian log density of linked point(s) v (leading batch axes
        allowed)."""
        u = (v - self.mean) @ self.chol_precision  # L' d on the last axis
        return -0.5 * torch.sum(u * u, dim=-1) - 0.5 * self.dim * _LOG2PI + self._half_logdet_h()

    def log_evidence(self):
        """Laplace evidence: log int p ~ logp(mode) + d/2 log 2pi - half log|H|."""
        return self.logdensity_at_mode + 0.5 * self.dim * _LOG2PI - self._half_logdet_h()

    def covariance(self):
        """Dense Sigma = H^-1 = L^-T L^-1 (dim x dim), for a dense metric's
        seed or reporting."""
        eye = torch.eye(self.dim, dtype=self.mean.dtype, device=self.mean.device)
        inv_l = torch.linalg.solve_triangular(self.chol_precision, eye, upper=False)
        return inv_l.T @ inv_l

    def marginal_sd(self):
        """Per-coordinate sd: sqrt(diag(Sigma)) from covariance()'s solve."""
        return torch.sqrt(torch.diagonal(self.covariance()))


def hessian(logdensity_fn, v):
    """The Hessian of logp at v (dim,): one double-backward pass over dim
    copies of v through the batch-major density. G = d sum(lp) / dV keeps
    its graph, and row i of d(sum_i G_ii) / dV is grad(dlp/dv_i) at v."""
    blogp = as_batched(logdensity_fn)
    dim = v.shape[-1]
    with torch.enable_grad():
        V = v.detach().expand(dim, dim).clone().requires_grad_(True)
        (G,) = torch.autograd.grad(blogp(V).sum(), V, create_graph=True)
        (H,) = torch.autograd.grad(torch.diagonal(G).sum(), V)
    return H


def laplace_approximation(logdensity_fn, v_star, jitter: float = 0.0) -> LaplaceApprox:
    """The Laplace approximation at a (MAP) point: one batched Hessian, one
    Cholesky factor. `jitter` adds jitter * I to H before factoring, for a
    mode on a nearly flat direction; without it such a factor is NaN, as
    the JAX package's is (loud, not silent)."""
    v_star = v_star.detach()
    h = -hessian(logdensity_fn, v_star)
    h = 0.5 * (h + h.T)
    if jitter:
        h = h + jitter * torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    chol, info = torch.linalg.cholesky_ex(h)
    chol = torch.where(info == 0, chol, torch.full_like(chol, math.nan))
    lp = as_batched(logdensity_fn)(v_star[None, :])[0].detach()
    return LaplaceApprox(v_star, chol, lp)


def map_laplace(model, v0=None, generator=None, n_steps: int = 200, optimizer=None,
                jitter: float = 0.0):
    """MAP, then the Laplace approximation, on a `Model` (its per-example
    density `logdensity_fn`). v0 defaults to zeros (the linked-space
    origin: every link maps it to an interior point); pass `generator`
    instead for a random start from `Model.init_positions`. Returns
    (MAPResult, LaplaceApprox)."""
    fn = model.logdensity_fn()
    if v0 is None:
        if generator is not None:
            v0 = model.init_positions(generator, 1)[0]
        else:
            v0 = torch.zeros(model.dim(), dtype=model.dtype, device=model.device)
    res = fit_map(fn, v0, n_steps=n_steps, optimizer=optimizer)
    return res, laplace_approximation(fn, res.position, jitter=jitter)
