"""NeuTra: neural-transport MCMC (Hoffman et al. 2019), PyTorch counterpart
of `tpu_bijectors/infer/neutra.py`. It composes the flow layers with the
engines:

1. fit a normalizing-flow posterior q = flow(N(0, I)) to the target by
   ADVI (`fit_advi` with a `FlowPosterior`: the reparameterized ELBO, the
   forward pass only);
2. run NUTS on the pulled-back density

       logp_z(z) = logp(flow(z)) + log|det J_flow(z)|

   whose geometry the trained flow has roughly whitened;
3. push the z draws through the flow's forward pass to the target space.
   The flow only preconditions: the draws stay asymptotically exact.

A leapfrog adds one pass of the flow's masked matrix products over the
chains; the flow's iterative inverse is never called. While NUTS runs the
flow's tensors are detached, so the sampler's autograd builds no graph
into the weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..flows.maf import flow_stack
from ..flows.params import flow_parameters, with_flow_parameters
from ..utils import resolve_device
from .advi import FlowPosterior, fit_advi
from .model import Model, as_batched


def neutra_logdensity(logdensity_fn, flow):
    """A flat-space log density pulled back through `flow` (z-space to the
    target space): logp_z(z) = logp(flow(z)) + logdetJ(z), batch-capable
    (the flow broadcasts over leading axes; the density is lifted by
    `as_batched`)."""
    blogp = as_batched(logdensity_fn)

    def logp_z(z):
        v, ld = flow.forward_and_log_det(z)
        return blogp(v) + ld

    logp_z.batch_capable = True
    return logp_z


class NeutraResult(NamedTuple):
    flow: object  # the trained transport map (z -> unconstrained target)
    losses: torch.Tensor  # ADVI's negative-ELBO trace


def fit_neutra_flow(
    logdensity_fn,
    generator,
    dim: int,
    n_layers: int = 4,
    hidden: int | None = None,
    n_steps: int = 1000,
    n_mc: int = 32,
    learning_rate: float = 5e-3,
    dtype=None,
    kind: str = "maf",
    device=None,
) -> NeutraResult:
    """Train the transport map, a MAF stack (kind='maf'; affine, the
    cheapest) or an NSF-AR stack (kind='nsf'; splines, for multimodal or
    heavier geometry), by maximizing the reparameterized ELBO against
    `logdensity_fn` (the sampling direction only). The flow is made on
    `device` (default `cuda`) in `dtype` (default torch's), its weights
    and the ELBO's draws from `generator`."""
    dtype = dtype or torch.get_default_dtype()
    flow = flow_stack(generator, dim, kind, n_layers=n_layers, hidden=hidden, dtype=dtype,
                      device=resolve_device(device))
    res = fit_advi(logdensity_fn, generator, dim, q=FlowPosterior(flow), n_steps=n_steps,
                   n_mc=n_mc, learning_rate=learning_rate, dtype=dtype)
    return NeutraResult(res.q.flow, res.losses)


def neutra_sample(
    model: Model,
    generator,
    n_chains: int = 8,
    n_warmup: int = 500,
    n_samples: int = 500,
    flow=None,
    constrained: bool = True,
    fit_kwargs: dict | None = None,
    kernel: str = "nuts_batched",
    **sample_kwargs,
):
    """One-call NeuTra on a Model: fit the transport (unless a trained
    `flow` is passed), NUTS in z-space (kernel='chees' runs ChEES-HMC, a
    natural pair for the near-spherical pulled-back geometry), then the
    draws transported and constrained. The flow is fitted on the model's
    device in its dtype.

    Returns (samples, result, stats): samples as Model.sample gives them
    ((n_kept, n_chains) leading axes), `result` a NeutraResult carrying the
    trained flow (reusable across runs)."""
    from .sampler import sample_with_kernel

    dim = model.dim()
    logp = model.batched_logdensity_fn()
    losses = torch.zeros((0,), dtype=model.dtype, device=model.device)
    if flow is None:
        kw = dict(dtype=model.dtype, device=model.device)
        kw.update(fit_kwargs or {})
        flow, losses = fit_neutra_flow(logp, generator, dim, **kw)
    flow = with_flow_parameters(flow, [t.detach() for t in flow_parameters(flow)])
    logp_z = neutra_logdensity(logp, flow)
    z0 = torch.randn((n_chains, dim), generator=generator, dtype=model.dtype,
                     device=model.device)
    z, _, stats = sample_with_kernel(logp_z, generator, z0, n_warmup=n_warmup,
                                     n_samples=n_samples, kernel=kernel, **sample_kwargs)
    with torch.no_grad():
        v = flow.forward(z)
        samples = model.constrain(v) if constrained else v
    return samples, NeutraResult(flow, losses), stats
