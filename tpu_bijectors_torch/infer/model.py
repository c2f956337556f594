"""Model abstraction, PyTorch counterpart of `tpu_bijectors/infer/model.py`.

A `Model` is (priors, loglik) on one device: priors is any distribution
`unconstrain` supports (typically a NamedProduct), loglik maps one sample
dict to a scalar (batched with `torch.func.vmap`, as the JAX package uses
`jax.vmap`). The unconstrained target density is

    logp(v) = priors.logpdf(x) + loglik(x) + logdetJ,   (x, logdetJ) = from_linked_vec(v)

It has two batched forms. The batch-major one (`batched_logdensity_fn`)
runs on (B, dim) states through each leaf's own link (the simplex and LKJ
kernels on the card) and autograd; the batch-major sampler
(`nuts_batched`) evaluates it. The transposed one
(`batched_logdensity_t_fn`) runs on the (dim, B) state: the prior term as
one fused kernel for the value and one for the value and gradient, the
likelihood term through the inverse link and autograd; `nuts_batched_t`
evaluates it. Both declare `batch_capable`, which `as_batched` (the
engines' lift of a density to whole blocks) reads. The per-example form
(`logdensity_fn`) evaluates the batch-major one on a block of one.
"""

from __future__ import annotations

import torch

from ..dists.base import Distribution, first_param
from ..utils import resolve_device
from ..vectorize.core import unconstrain


def _param_dtype(d: Distribution):
    """The floating dtype of a distribution's parameters (its first leaf's)."""
    p = first_param(d)
    return torch.get_default_dtype() if p is None else p.dtype


class Model:
    """Priors and an optional log-likelihood on `device` (default `cuda`;
    raises when CUDA is absent and no device was given)."""

    def __init__(self, priors: Distribution, loglik=None, *, device=None):
        self.device = resolve_device(device)
        self.priors = priors.to(self.device)
        self.loglik = loglik
        self.dtype = _param_dtype(self.priors)
        self._u = unconstrain(self.priors, device=self.device)

    def unconstrainer(self):
        return self._u

    def dim(self) -> int:
        return self._u.linked_vec_length

    def constrain(self, v):
        """Flat unconstrained vectors (..., dim) -> sample dict with the same
        leading axes."""
        return self._u.from_linked_vec(v)[0]

    def logdensity_fn(self):
        """logp(v) on one flat unconstrained vector (dim,) -> (), the JAX
        package's per-example density (the `nuts` and `hmc` kernels take
        it). It evaluates `batched_logdensity_fn` on the (1, dim) view of v
        (the link kernels' autograd Functions do not vmap), so its value
        and gradient are the batch-major density's; leading batch axes
        are evaluated as a block. `as_batched` lifts it to that batch-major
        density (its `batched_form`)."""
        batched = self.batched_logdensity_fn()

        def logdensity(v):
            return batched(v.reshape(-1, v.shape[-1])).reshape(v.shape[:-1])

        logdensity.batched_form = batched
        return logdensity

    def batched_logdensity_fn(self):
        """logp on batch-major (B, dim) states, (B,) out. Prior-only it is
        `linked_logdensity` (the LKJ leaf through its log-det kernel, X
        never formed); with a likelihood, `from_linked_vec_with_logpdf`
        plus the likelihood vmapped over the batch. Its
        `value_and_grad_fn(v)` returns (lp, d sum(lp) / dv) through
        autograd (the kernels' closed-form backward passes)."""
        u = self._u
        loglik = self.loglik

        if loglik is None:

            def logdensity(v):
                return u.linked_logdensity(v)

        else:

            def logdensity(v):
                x, lp = u.from_linked_vec_with_logpdf(v)
                return lp + (torch.func.vmap(loglik)(x) if v.ndim > 1 else loglik(x))

        def value_and_grad_fn(v):
            with torch.enable_grad():
                vv = v.detach().requires_grad_(True)
                lp = logdensity(vv)
                (g,) = torch.autograd.grad(lp.sum(), vv)
            return lp.detach(), g

        logdensity.value_and_grad_fn = value_and_grad_fn
        logdensity.batch_capable = True
        return logdensity

    def batched_logdensity_t_fn(self):
        """logp on the transposed (dim, B) state, (B,) out. Its
        `value_and_grad_fn(vT)` returns (lp, d sum(lp) / d vT): the prior
        term from the fused one-pass kernel (for a CPU state whose model
        has no fused plan, autograd through the composed path), plus the
        likelihood term and its reverse pass through the inverse link on
        the swapped view of vT."""
        u = self._u
        loglik = self.loglik

        def _prior_vg(vT):
            from ..vectorize.fused_kernel import try_mega_value_and_grad

            out = try_mega_value_and_grad(u, vT)
            if out is not None:
                return out
            with torch.enable_grad():
                v = vT.detach().requires_grad_(True)
                lp = u.linked_logdensity_t(v)
                (g,) = torch.autograd.grad(lp.sum(), v)
            return lp.detach(), g

        if loglik is None:

            def prior_logdensity_t(vT):
                return u.linked_logdensity_t(vT)

            prior_logdensity_t.value_and_grad_fn = _prior_vg
            prior_logdensity_t.batch_capable = True
            return prior_logdensity_t

        def lik_t(vT):
            x = u.from_linked_vec(vT.transpose(0, 1))[0]
            return torch.func.vmap(loglik)(x)

        def logdensity_t(vT):
            return u.linked_logdensity_t(vT) + lik_t(vT)

        def _full_vg(vT):
            lp_p, g_p = _prior_vg(vT)
            with torch.enable_grad():
                v = vT.detach().requires_grad_(True)
                lp_l = lik_t(v)
                (g_l,) = torch.autograd.grad(lp_l.sum(), v)
            return lp_p + lp_l.detach(), g_p + g_l

        logdensity_t.value_and_grad_fn = _full_vg
        logdensity_t.batch_capable = True
        return logdensity_t

    def init_positions(self, generator, n_chains: int, scale: float = 1.0):
        """scale * N(0, 1) starting positions (n_chains, dim), drawn from
        `generator` on the model's device."""
        return scale * torch.randn(
            (n_chains, self.dim()), generator=generator, dtype=self.dtype,
            device=self.device,
        )

    def _auto_kernel(self):
        """The kernel `sample(kernel='auto')` runs: `nuts_batched_t` where
        the kernels are enabled and the model has a fused plan, else
        `nuts_batched`."""
        from .. import kernels
        from ..vectorize.core import TreeUnconstrainer
        from ..vectorize.fused_plan import _plan

        u = self._u
        eligible = (
            kernels.enabled()
            and isinstance(u, TreeUnconstrainer)
            and _plan(u) is not None
        )
        return "nuts_batched_t" if eligible else "nuts_batched"

    def _init(self, generator, n_chains, init, kwargs):
        """The starts (n_chains, dim) of `sample(init=...)`, seeding
        kwargs['inv_mass0'] where the init gives one and the caller did
        not."""
        if init == "laplace":
            from .map_laplace import map_laplace

            _, lap = map_laplace(self)
            q0 = lap.sample(generator, n_chains)
            if "inv_mass0" not in kwargs:
                kwargs["inv_mass0"] = (lap.covariance() if kwargs.get("metric") == "dense"
                                       else lap.marginal_sd() ** 2)
            return q0
        if init == "pathfinder":
            from .pathfinder import fit_pathfinder

            res = fit_pathfinder(
                self.logdensity_fn(), generator,
                torch.zeros(self.dim(), dtype=self.dtype, device=self.device),
                n_draws=n_chains,
            )
            if "inv_mass0" not in kwargs and kwargs.get("metric") != "dense":
                # diag(Sigma) = alpha + rowsum(beta * (beta gamma)): gamma is symmetric
                diag = res.alpha + torch.sum(res.beta * (res.beta @ res.gamma), dim=1)
                kwargs["inv_mass0"] = torch.clamp(diag, min=1e-10)
            return res.draws
        return self.init_positions(generator, n_chains)

    def sample(
        self,
        generator,
        n_chains: int = 8,
        n_warmup: int = 500,
        n_samples: int = 500,
        kernel: str = "auto",
        constrained: bool = True,
        init: str = "random",
        **kwargs,
    ):
        """One-call sampling: warmup, then draws, with the density each
        kernel takes.

        kernel='auto' picks the transposed-layout multi-chain kernel
        (`nuts_batched_t`) whenever the kernels are enabled and the model
        has a fused plan, on either device; the leapfrog then runs the
        one-pass fused value-and-grad kernel (and, with a likelihood, the
        inverse-link kernels). Otherwise it picks the batch-major
        multi-chain kernel (`nuts_batched`, on `batched_logdensity_fn`), as
        the JAX package does; on the card with the kernels disabled its
        launches raise. Any `warmup_and_sample` kernel name may be passed:
        'nuts' and 'hmc' (on the per-example `logdensity_fn`),
        'nuts_batched', 'nuts_batched_t', and 'chees' (`run_chees` on the
        batch-major density); `metric='dense'` and the other keywords go
        to the engine. Returns (samples, state, stats): samples is the
        constrained dict with leading (n_kept, n_chains) axes when
        `constrained=True`, else the raw (n_kept, n_chains, dim) linked
        tensor. Every random draw comes from `generator` (on the model's
        device).

        init='random' draws N(0, 1) starting positions; 'laplace' runs
        map_laplace and starts the chains from the Laplace Gaussian's
        draws, the inverse mass seeded from its covariance (dense metric)
        or its marginal variances (diagonal); 'pathfinder' runs
        fit_pathfinder from zeros and starts the chains from its
        best-candidate draws, the diagonal metric seeded with diag(Sigma).
        Warmup still adapts; a user-passed `inv_mass0` wins."""
        from .sampler import sample_with_kernel

        if kernel == "auto":
            kernel = self._auto_kernel()
        if init not in ("random", "laplace", "pathfinder"):
            raise ValueError(f"unknown init {init!r}")
        densities = {
            "nuts": self.logdensity_fn,
            "hmc": self.logdensity_fn,
            "nuts_batched": self.batched_logdensity_fn,
            "nuts_batched_t": self.batched_logdensity_t_fn,
            "chees": self.batched_logdensity_fn,
        }
        if kernel not in densities:
            raise ValueError(f"unknown kernel {kernel!r}")
        fn = densities[kernel]()
        q0 = self._init(generator, n_chains, init, kwargs)
        samples, state, stats = sample_with_kernel(
            fn, generator, q0, n_warmup=n_warmup, n_samples=n_samples,
            kernel=kernel, **kwargs,
        )
        if constrained:
            samples = self.constrain(samples)
        return samples, state, stats


def as_batched(logdensity_fn):
    """A log-density lifted to whole (batch, dim) blocks: the function itself
    when it declares batch support (`fn.batch_capable = True`, as
    Model.batched_logdensity_fn does), the batch-major form it carries
    (`fn.batched_form`: Model.logdensity_fn), else `torch.func.vmap` of it.

    Opt-in by attribute rather than a shape probe: a per-example density
    whose reductions happen to broadcast back to (batch,) would pass a
    shape check while silently mixing samples' likelihoods. Used by the
    ADVI, SMC and ChEES engines and the per-chain kernels."""
    if getattr(logdensity_fn, "batch_capable", False):
        return logdensity_fn
    batched = getattr(logdensity_fn, "batched_form", None)
    if batched is not None:
        return batched

    def vmapped(v):
        if v.ndim == 1:
            return logdensity_fn(v)
        return torch.func.vmap(logdensity_fn)(v)

    return vmapped
