"""Model abstraction, PyTorch counterpart of `tpu_bijectors/infer/model.py`.

A `Model` holds priors (any distribution `unconstrain` supports, typically
a NamedProduct) on one device. Its batched transposed log-density is what
a sampler or a server evaluates: on the (dim, B) state, one fused kernel
for the value and one for the value and gradient.
"""

from __future__ import annotations

import torch

from ..dists.base import Distribution
from ..utils import resolve_device
from ..vectorize.core import unconstrain


class Model:
    """Priors, and (not ported yet) a log-likelihood, on `device` (default
    `cuda`; raises when CUDA is absent and no device was given)."""

    def __init__(self, priors: Distribution, loglik=None, *, device=None):
        if loglik is not None:
            raise NotImplementedError(
                "a log-likelihood is not ported yet; Model takes priors only"
            )
        self.device = resolve_device(device)
        self.priors = priors.to(self.device)
        self._u = unconstrain(self.priors, device=self.device)

    def unconstrainer(self):
        return self._u

    def dim(self) -> int:
        return self._u.linked_vec_length

    def constrain(self, v):
        """Flat unconstrained vectors (B, dim) -> sample dict."""
        return self._u.from_linked_vec(v)[0]

    def batched_logdensity_t_fn(self):
        """logp on the transposed (dim, B) state, (B,) out. Its
        `value_and_grad_fn(vT)` returns (lp, d sum(lp) / d vT) in one fused
        pass; for a CPU state whose model has no fused plan it
        differentiates the composed path instead."""
        u = self._u

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

        def prior_logdensity_t(vT):
            return u.linked_logdensity_t(vT)

        prior_logdensity_t.value_and_grad_fn = _prior_vg
        return prior_logdensity_t

    def sample(self, *args, **kwargs):
        raise NotImplementedError("NUTS sampling is not ported yet")
