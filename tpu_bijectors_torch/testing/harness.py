"""Bijector property harness, PyTorch counterpart of
`tpu_bijectors/testing/harness.py` (reference src/vector/test_utils.jl
and test/bijectors/utils.jl):

* round trips b^-1(b(x)) = x and b(b^-1(y)) = y;
* logdetJ(b^-1, y) = -logdetJ(b, x);
* the analytic log-det against the slogdet of autograd's Jacobian (the
  reference's ForwardDiff oracle, test_utils.jl:573-633), with free charts
  `to_free`/`from_free` for dimension-changing bijectors
  (test_utils.jl:92-244);
* the shape algebra (`forward_event_shape`, utils.jl:36-38).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def check_logdet_against_jacobian(fn, x_flat, expected_logdet, atol=1e-8, rtol=1e-8, msg=""):
    """log|det J| of fn: R^n -> R^n at x_flat (autograd's Jacobian) against
    the analytic value."""
    J = torch.autograd.functional.jacobian(fn, x_flat)
    logdet = torch.linalg.slogdet(J)[1]
    np.testing.assert_allclose(_np(logdet), _np(expected_logdet), atol=atol, rtol=rtol,
                               err_msg=f"autograd-vs-analytic logdetJ mismatch {msg}")


def random_unconstrained(rng, shape, scale=1.0, dtype=torch.float64, device="cpu"):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=dtype, device=device)


def assert_bijector_ok(b, x, *, to_free=None, from_free=None, y_to_free=None,
                       y_from_free=None, atol=1e-8, rtol=1e-7, test_jacobian=True,
                       event_ndims_in=None, event_ndims_out=None):
    """The reference's property set on bijector `b` at point `x`. The free
    charts default to the ravel (dimension-preserving bijectors); pass
    to_free / from_free (and y_to_free / y_from_free for the output) for
    dimension-changing ones (simplex, correlation, packed PD)."""
    n_in = b.event_ndims_in if event_ndims_in is None else event_ndims_in
    n_out = b.event_ndims_out if event_ndims_out is None else event_ndims_out

    y, ld_fwd = b.forward_and_log_det(x)
    np.testing.assert_allclose(_np(y), _np(b.forward(x)), atol=atol, rtol=rtol)

    ev_in = tuple(x.shape[x.ndim - n_in:]) if n_in else ()
    ev_out = tuple(y.shape[y.ndim - n_out:]) if n_out else ()
    assert tuple(b.forward_event_shape(ev_in)) == ev_out, (
        f"forward_event_shape({ev_in}) = {b.forward_event_shape(ev_in)} != {ev_out}")
    assert tuple(b.inverse_event_shape(ev_out)) == ev_in

    np.testing.assert_allclose(_np(b.inverse(y)), _np(x), atol=atol, rtol=rtol,
                               err_msg="inverse(forward(x)) != x")
    x3, ld_inv = b.inverse_and_log_det(y)
    np.testing.assert_allclose(_np(x3), _np(x), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(ld_inv), -_np(ld_fwd), atol=atol, rtol=rtol,
                               err_msg="inverse log-det != -forward log-det")
    if not test_jacobian:
        return
    assert x.ndim == n_in, "pass a single event (no batch dims) for the Jacobian test"
    if to_free is None:
        to_free, from_free = (lambda e: e.reshape(-1)), (lambda f: f.reshape(ev_in))
    if y_to_free is None:
        y_to_free, y_from_free = (lambda e: e.reshape(-1)), (lambda f: f.reshape(ev_out))
    check_logdet_against_jacobian(lambda f: y_to_free(b.forward(from_free(f))), to_free(x),
                                  ld_fwd, atol=atol, rtol=rtol, msg="fwd")
    check_logdet_against_jacobian(lambda f: to_free(b.inverse(y_from_free(f))), y_to_free(y),
                                  ld_inv, atol=atol, rtol=rtol, msg="inv")
