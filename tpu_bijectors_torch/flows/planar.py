"""Planar flow layer and the `find_alpha` root solve, PyTorch counterparts
of `tpu_bijectors/flows/planar.py` (reference planar_layer.jl; Rezende &
Mohamed 2015, eq. 10-12, 21-23):

  forward:  f(z) = z + u_hat * tanh(w'z + b)
            u_hat = u + (log1pexp(-w'u) - 1) * w / |w|^2   (invertibility)
            w'u_hat = log1pexp(w'u) - 1 > -1
  logdetJ:  log1p(w'u_hat * sech^2(w'z + b))
  inverse:  solve w'y = alpha + w'u_hat * tanh(alpha + b) for alpha, then
            z = y - u_hat * tanh(alpha + b)

`find_alpha` is the JAX package's fixed-count bisection inside the
bracket [wt_y - 2|wt_u_hat|, wt_y + 2|wt_u_hat|], 96 steps on the
tensors' device with no read to the host. Autograd does not enter the
iteration: a `torch.autograd.Function` gives the implicit-function
derivative in both modes (backward and `jvp`), the JAX package's custom
JVP (ext/BijectorsChainRulesCoreExt.jl:42-46). In float32 the bracket
stops shrinking long before 96 steps; the iterate then stays put.
"""

from __future__ import annotations

import torch

from ..bijectors.base import Bijector, bijector_dataclass
from ..utils import log1pexp, resolve_device

_N_BISECT = 96  # enough to reach float64's ulp on any realistic bracket


def _find_alpha_plain(wt_y, wt_u_hat, b):
    delta = 2.0 * torch.abs(wt_u_hat)
    lower, upper = wt_y - delta, wt_y + delta
    lo, hi = lower, upper
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        fm = mid + wt_u_hat * torch.tanh(mid + b) - wt_y
        lo = torch.where(fm <= 0, mid, lo)
        hi = torch.where(fm > 0, mid, hi)
    # empty bracket (wt_u_hat == 0): the endpoint (planar_layer.jl:170-173)
    return torch.where(lower == upper, lower, 0.5 * (lo + hi))


def _partials(alpha, wt_u_hat, b):
    """(d alpha / d wt_y, d alpha / d wt_u_hat, d alpha / d b) with
    x = 1 / (1 + wt_u_hat sech^2(alpha + b)): x, -tanh(alpha + b) x, x - 1."""
    t = torch.tanh(alpha + b)
    x = 1.0 / (1.0 + wt_u_hat * (1.0 - t * t))
    return x, -t * x, x - 1.0


class _FindAlpha(torch.autograd.Function):
    """alpha of broadcast (wt_y, wt_u_hat, b): the bisection forward, the
    implicit-function rule backward and forward (`setup_context` form, so
    torch.func's transforms enter it too)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(wt_y, wt_u_hat, b):
        return _find_alpha_plain(wt_y, wt_u_hat, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, wt_u_hat, b = inputs
        ctx.save_for_backward(output, wt_u_hat, b)
        ctx.save_for_forward(output, wt_u_hat, b)

    @staticmethod
    def backward(ctx, g):
        alpha, wt_u_hat, b = ctx.saved_tensors
        return tuple(g * p for p in _partials(alpha, wt_u_hat, b))

    @staticmethod
    def jvp(ctx, dy, du, db):
        alpha, wt_u_hat, b = ctx.saved_tensors
        out = torch.zeros_like(alpha)
        for p, d in zip(_partials(alpha, wt_u_hat, b), (dy, du, db)):
            if d is not None:
                out = out + p * d
        return out


def find_alpha(wt_y, wt_u_hat, b):
    """Solve alpha + wt_u_hat * tanh(alpha + b) - wt_y = 0 elementwise
    (broadcast). Monotone in alpha since wt_u_hat > -1, so the bisection
    converges on the whole bracket; handles the empty bracket
    (wt_u_hat == 0, planar_layer.jl:170-173) and b = -1e8
    (test/normalising_flows.jl:47-71). Numbers become tensors of the
    tensors' dtype and device (the default dtype if none is a tensor)."""
    like = next((a for a in (wt_y, wt_u_hat, b) if isinstance(a, torch.Tensor)), None)
    dtype = like.dtype if like is not None else torch.get_default_dtype()
    device = like.device if like is not None else None
    args = [torch.as_tensor(a, dtype=dtype, device=device) for a in (wt_y, wt_u_hat, b)]
    shape = torch.broadcast_shapes(*(a.shape for a in args))
    # autograd sums each input's gradient back through its expand
    return _FindAlpha.apply(*(a.expand(shape) for a in args))


@bijector_dataclass
class PlanarLayer(Bijector):
    """Trainable planar flow layer (reference PlanarLayer): w, u (dim,),
    b a scalar of shape () or (1,)."""

    w: torch.Tensor
    u: torch.Tensor
    b: torch.Tensor

    event_ndims_in = 1
    event_ndims_out = 1
    closed_form_inverse = False  # reference `isclosedform`, planar_layer.jl:188

    @classmethod
    def init(cls, generator, dim: int, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        kw = dict(generator=generator, dtype=dtype, device=dev)
        return cls(torch.randn(dim, **kw), torch.randn(dim, **kw), torch.randn((), **kw))

    def _u_hat(self):
        w, u = self.w, self.u
        wT_u = torch.sum(w * u, -1)
        u_hat = u + ((log1pexp(-wT_u) - 1.0) / torch.sum(w * w, -1)) * w
        return u_hat, log1pexp(wT_u) - 1.0

    def forward_and_log_det(self, z):
        b = self.b.reshape(())
        u_hat, wT_u_hat = self._u_hat()
        t = torch.tanh(torch.sum(self.w * z, -1) + b)
        y = z + u_hat * t[..., None]
        return y, torch.log1p(wT_u_hat * (1.0 - t * t))

    def inverse(self, y):
        b = self.b.reshape(())
        u_hat, wT_u_hat = self._u_hat()
        alpha = find_alpha(torch.sum(self.w * y, -1), wT_u_hat, b)
        return y - u_hat * torch.tanh(alpha + b)[..., None]
