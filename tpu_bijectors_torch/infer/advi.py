"""ADVI, PyTorch counterpart of `tpu_bijectors/infer/advi.py`: automatic
differentiation variational inference in unconstrained space with a
mean-field or full-rank Gaussian or a normalizing-flow posterior.

The variational family lives on the flat unconstrained vector of the
vectorize layer; the ELBO

    E_q[ logp(from_linked(v)) + logdetJ(v) ] + H[q]

is estimated with reparameterized Monte-Carlo draws, one (n_mc, dim) block
a step, or (dim, n_mc) in the transposed layout, where a
`Model.batched_logdensity_t_fn` density runs the whole-model value kernel
and its vector-Jacobian kernel as the backward. The families are
`NamedTuple`s of tensors, and `FlowPosterior` pushes standard normals
through a trainable flow (the `flows` package); the optimiser is a
`torch.optim` optimiser over the family's tensors (a Gaussian's fields, a
flow's `flow_parameters`), by default Adam with optax's defaults, the JAX
package's `optax.adam`. Both go through the same loop, which rebuilds the
family around the optimiser's tensors each step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..flows.params import flow_parameters, with_flow_parameters
from ..utils import resolve_device
from .model import as_batched

LOG_2PI = math.log(2.0 * math.pi)


def _gaussian_draws_and_logq(q, eps):
    """A Gaussian's draws of standard normals eps (n, dim) and their log q."""
    v = q._from_eps(eps)
    return v, q.logdensity(v)


def _gaussian_elbo(q, blogp, eps, transposed):
    """A Gaussian's ELBO estimate on eps, its entropy in closed form."""
    v = q._from_eps_t(eps) if transposed else q._from_eps(eps)
    return torch.mean(blogp(v)) + q.entropy()


class MeanFieldGaussian(NamedTuple):
    """q(v) = N(loc, diag(exp(log_scale)^2)); entropy in closed form."""

    loc: torch.Tensor
    log_scale: torch.Tensor

    @classmethod
    def init(cls, dim: int, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        return cls(torch.zeros(dim, dtype=dtype, device=dev),
                   torch.full((dim,), -1.0, dtype=dtype, device=dev))

    def _tensors(self):
        return list(self)

    def _rebuild(self, tensors):
        return type(self)(*tensors)

    def _from_eps(self, eps):
        """The draws loc + scale * eps of standard normals eps (n, dim)."""
        return self.loc + torch.exp(self.log_scale) * eps

    def _from_eps_t(self, eps):
        """The draws of standard normals eps (dim, n), in that layout."""
        return self.loc[:, None] + torch.exp(self.log_scale)[:, None] * eps

    def sample(self, generator, n: int):
        return self._from_eps(_normal(generator, self.loc, (n,) + tuple(self.loc.shape)))

    def sample_t(self, generator, n: int):
        """(dim, n) draws: MC samples on the columns, the layout the
        whole-model kernels want."""
        return self._from_eps_t(_normal(generator, self.loc, tuple(self.loc.shape) + (n,)))

    def entropy(self):
        d = self.loc.shape[-1]
        return torch.sum(self.log_scale) + 0.5 * d * (1.0 + LOG_2PI)

    def logdensity(self, v):
        """Normalized log q(v), leading batch axes allowed."""
        d = self.loc.shape[-1]
        z = (v - self.loc) * torch.exp(-self.log_scale)
        return -0.5 * torch.sum(z * z, dim=-1) - torch.sum(self.log_scale) - 0.5 * d * LOG_2PI

    _draws_and_logq = _gaussian_draws_and_logq
    _elbo = _gaussian_elbo


class FullRankGaussian(NamedTuple):
    """q(v) = N(loc, L L^T), L lower-triangular with its diagonal exp of
    tril_raw's."""

    loc: torch.Tensor
    tril_raw: torch.Tensor  # (dim, dim)

    @classmethod
    def init(cls, dim: int, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        return cls(torch.zeros(dim, dtype=dtype, device=dev),
                   -1.0 * torch.eye(dim, dtype=dtype, device=dev))

    def _L(self):
        eye = torch.eye(self.loc.shape[-1], dtype=self.loc.dtype, device=self.loc.device)
        return torch.tril(self.tril_raw, -1) + eye * torch.exp(torch.diagonal(self.tril_raw))

    def _tensors(self):
        return list(self)

    def _rebuild(self, tensors):
        return type(self)(*tensors)

    def _from_eps(self, eps):
        return self.loc + eps @ self._L().T

    def _from_eps_t(self, eps):
        return self.loc[:, None] + self._L() @ eps

    def sample(self, generator, n: int):
        return self._from_eps(_normal(generator, self.loc, (n,) + tuple(self.loc.shape)))

    def sample_t(self, generator, n: int):
        """(dim, n) draws (see MeanFieldGaussian.sample_t)."""
        return self._from_eps_t(_normal(generator, self.loc, tuple(self.loc.shape) + (n,)))

    def entropy(self):
        d = self.loc.shape[-1]
        return torch.sum(torch.diagonal(self.tril_raw)) + 0.5 * d * (1.0 + LOG_2PI)

    def logdensity(self, v):
        """Normalized log q(v), leading batch axes allowed (one triangular
        solve)."""
        d = self.loc.shape[-1]
        diff = v - self.loc
        u = torch.linalg.solve_triangular(
            self._L(), diff.reshape(-1, d).T, upper=False
        ).T.reshape(diff.shape)
        return (-0.5 * torch.sum(u * u, dim=-1) - torch.sum(torch.diagonal(self.tril_raw))
                - 0.5 * d * LOG_2PI)

    _draws_and_logq = _gaussian_draws_and_logq
    _elbo = _gaussian_elbo


class FlowPosterior(NamedTuple):
    """q = flow(N(0, I)): reparameterized draws are base draws pushed through
    the trainable flow (event_ndims 1), and log q uses the flow's forward
    log-det (training never needs the iterative inverse)."""

    flow: object

    def _tensors(self):
        return flow_parameters(self.flow)

    def _rebuild(self, tensors):
        return FlowPosterior(with_flow_parameters(self.flow, tensors))

    def _draws_and_logq(self, eps):
        """(v, log q(v)) of the base draws eps (n, dim)."""
        dim = eps.shape[-1]
        logq0 = -0.5 * torch.sum(eps * eps, dim=-1) - 0.5 * dim * LOG_2PI
        v, ld = self.flow.forward_and_log_det(eps)
        return v, logq0 - ld

    def _elbo(self, blogp, eps, transposed):
        v, logq = self._draws_and_logq(eps)
        return torch.mean(blogp(v) - logq)

    def sample_with_logq(self, generator, n: int, dim: int):
        """n draws and their log q, from `generator` on the flow's device."""
        return self._draws_and_logq(_normal(generator, _like(self), (n, dim)))


def _like(q):
    """A tensor of the family's dtype and device (its draws are made so)."""
    return q._tensors()[0]


class ADVIResult(NamedTuple):
    q: object
    losses: torch.Tensor


def _normal(generator, like, shape):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _neg_elbo(q, blogp, eps, estimator: str, transposed: bool, n_iw: int):
    """The negative ELBO estimate of q on the standard normals eps: (n_mc,
    dim), (dim, n_mc) when transposed, (n_mc * n_iw, dim) for 'iwelbo'.
    Differentiable in q's tensors. Every family gives `_tensors`,
    `_rebuild`, `_draws_and_logq` and `_elbo`; 'stl' (Gaussians only) its
    `logdensity` too."""
    if estimator == "iwelbo":
        v, logq = q._draws_and_logq(eps)
        logw = (blogp(v) - logq).reshape(-1, n_iw)
        return -torch.mean(torch.logsumexp(logw, dim=1) - math.log(float(n_iw)))
    if estimator == "stl":
        # sticking the landing: log q with q's parameters held fixed
        v = q._from_eps_t(eps) if transposed else q._from_eps(eps)
        q_stop = q._rebuild([t.detach() for t in q._tensors()])
        vb = v.T if transposed else v
        return -torch.mean(blogp(v) - q_stop.logdensity(vb))
    return -q._elbo(blogp, eps, transposed)


def _adam(learning_rate: float):
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8): torch's Adam
    computes the same update."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8)


def _fit(q, blogp, opt_factory, eps_draws, estimator: str, transposed: bool, n_iw: int):
    """The optimisation loop over the given draws (one eps block a step):
    ADVIResult of the fitted q and the losses."""
    params = [t.detach().clone().requires_grad_(True) for t in q._tensors()]
    opt = opt_factory(params)
    losses = []
    for eps in eps_draws:
        loss = _neg_elbo(q._rebuild(params), blogp, eps, estimator, transposed, n_iw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    fitted = q._rebuild([p.detach() for p in params])
    if not losses:
        return ADVIResult(fitted, _like(q).new_empty((0,)))
    return ADVIResult(fitted, torch.stack(losses))


def fit_advi(
    logdensity_fn,
    generator,
    dim: int,
    q=None,
    n_steps: int = 1000,
    n_mc: int = 32,
    learning_rate: float = 1e-2,
    optimizer=None,
    dtype=torch.float32,
    transposed: bool = False,
    estimator: str = "elbo",
    n_iw: int = 8,
    device=None,
) -> ADVIResult:
    """Maximize the ELBO over q's tensors; q defaults to
    MeanFieldGaussian.init(dim) on `device` (default `cuda`; raises where
    CUDA is absent and no device was given), and a given q keeps its own
    device. q may be a Gaussian family or a FlowPosterior (estimator
    'elbo' or 'iwelbo', batch-major). `optimizer` is a factory that
    takes the list of parameter tensors and returns a `torch.optim`
    optimiser; the default is Adam with `learning_rate`.

    transposed=True draws the MC samples in the (dim, n_mc) layout
    (sample_t) and requires a batch-capable density mapping (dim, n) ->
    (n,) (e.g. Model.batched_logdensity_t_fn): for eligible priors the
    density term and its backward each run as one whole-model kernel a
    step, the backward with the cotangent of the mean.

    estimator='stl' uses the sticking-the-landing path-derivative gradient
    (Roeder, Wu & Duvenaud 2017): the entropy term is -log q at the
    reparameterized draw with q's parameters held fixed, so the per-sample
    gradient vanishes when q matches the target. estimator='iwelbo'
    maximizes the importance-weighted bound (Burda, Grosse & Salakhutdinov
    2016), n_mc groups of n_iw draws (batch-major only). Every draw comes
    from `generator` (on q's device)."""
    if q is None:
        q = MeanFieldGaussian.init(dim, dtype, device)
    if estimator not in ("elbo", "stl", "iwelbo"):
        raise ValueError(f"unknown estimator {estimator!r}")
    if estimator == "stl" and isinstance(q, FlowPosterior):
        raise ValueError("estimator='stl' supports Gaussian families only")
    if estimator == "iwelbo" and transposed:
        raise ValueError("estimator='iwelbo' does not support transposed=True")
    if transposed and isinstance(q, FlowPosterior):
        raise ValueError("transposed=True supports Gaussian families only")
    if transposed and not getattr(logdensity_fn, "batch_capable", False):
        raise ValueError(
            "transposed=True requires a batch-capable log density "
            "mapping (dim, n) -> (n,) (e.g. Model.batched_logdensity_t_fn)"
        )
    n_draws = n_mc * n_iw if estimator == "iwelbo" else n_mc
    shape = (dim, n_draws) if transposed else (n_draws, dim)
    eps_draws = (_normal(generator, _like(q), shape) for _ in range(n_steps))
    return _fit(q, as_batched(logdensity_fn), optimizer or _adam(learning_rate), eps_draws,
                estimator, transposed, n_iw)
