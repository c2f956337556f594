"""Distribution-level property sweep, PyTorch counterpart of
`tpu_bijectors/testing/sweep.py` (the reference's `VectorBijectors.test_all`,
src/vector/test_utils.jl:246-277). One call runs the property set against
`unconstrain(d)`, on the device and in the dtype of d's parameters:

1. roundtrip          samples: from_vec(to_vec(x)) = x, the linked round
                      trip, and the inverse log-det = -the forward's
                      (:284-312)
2. roundtrip_inverse  random unconstrained vectors: from_linked_vec lands in
                      the support and to_linked(from_linked(v)) = v
                      (:325-374)
3. launch stability   the stand-in for the JAX sweep's trace stability
                      (jit traces once, :385-413), which has no torch
                      counterpart: torch does not trace. Two calls of
                      `from_linked_vec` and of `linked_logdensity_t` at one
                      shape launch the same kernels the same number of
                      times (`kernels.LAUNCHES`; on the CPU, none), and the
                      fused evaluation's table cache (`_PREP_CACHE`) holds
                      one entry per (dtype, device) it served: no shape or
                      second call builds another
4. static lengths     vec_length / linked_vec_length are ints that match
                      the shapes (:480-497)
5. optic sparsity     a linked coordinate that is not entangled depends
                      only on its claimed input (the support of the
                      forward-mode Jacobian, :419-473)
6. logjac vs autograd the linked log-det against the slogdet of autograd's
                      Jacobian through square free charts (:92-244,
                      :573-633)
7. logpdf consistency logpdf(x) - logdetJ = logpdf_with_trans(d, x, true)
8. gradient           the gradients of the linked log-density and of the
                      inverse link's log-det against central differences
                      (:639-717): catches a silently zero derivative rule
9. full Jacobian      the forward-mode Jacobian of from_linked_vec, column
                      by column through `torch.autograd.forward_ad`,
                      against the reverse-mode one of
                      `torch.autograd.functional.jacobian` (a wrong `jvp`
                      or backward of a link Function), and both against
                      central differences element by element. The link
                      Functions do not vmap, so `torch.func.jacfwd` is not
                      used.

The arguments and tolerances are the JAX sweep's. The finite-difference
noise constant kappa is measured on the current device and dtype
(`_measured_kappa`) and printed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .. import kernels
from ..dists.base import Distribution, first_param
from ..vectorize.core import (
    IIDUnconstrainer,
    LeafUnconstrainer,
    TransformedUnconstrainer,
    TreeUnconstrainer,
    Unconstrainer,
    unconstrain,
)

_KAPPA_CACHE = {}


def _np(t):
    return t.detach().cpu().numpy()


def _measured_kappa(dtype, device) -> float:
    """The evaluation-roundoff constant kappa (df ~ kappa eps (1 + |f|)) of
    the sweep's hottest mixed model (Normal + Dirichlet(4) + LKJ(3)) on
    this device and dtype: central differences at h = sqrt(eps), where the
    truncation error is O(eps) and the roundoff contributes df / h, give
    kappa ~ max |FD - g| h / (eps (1 + |f|)). Clamped to [16, 4096],
    cached per (device type, dtype), printed once."""
    key = (torch.device(device).type, str(dtype))
    if key in _KAPPA_CACHE:
        return _KAPPA_CACHE[key]
    from .. import dists

    d = dists.NamedProduct.of(
        mu=dists.Normal(0.0, 1.0, device=device, dtype=dtype),
        w=dists.Dirichlet(torch.ones(4), device=device, dtype=dtype),
        c=dists.LKJ(3, 2.0, device=device, dtype=dtype),
    )
    u = unconstrain(d, device=device)
    dim = u.linked_vec_length
    rng = np.random.default_rng(23)
    y = torch.as_tensor(rng.standard_normal(dim) * 0.3, dtype=dtype, device=device)
    eps = float(torch.finfo(dtype).eps)
    h = eps**0.5
    yy = y.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(u.linked_logdensity(yy[None, :]).sum(), yy)
    E = torch.eye(dim, dtype=dtype, device=device) * h
    with torch.no_grad():
        fd = (u.linked_logdensity(y + E) - u.linked_logdensity(y - E)) / (2.0 * h)
        f0 = 1.0 + float(u.linked_logdensity(y[None, :]).abs().max())
    kappa = float((fd - g).abs().max()) * h / (eps * f0)
    kappa = min(max(kappa, 16.0), 4096.0)
    print(f"[sweep] measured FD noise kappa={kappa:.1f} (device={key[0]}, dtype={key[1]})")
    _KAPPA_CACHE[key] = kappa
    return kappa


def _free_chart(u: Unconstrainer, x):
    """Sample -> free coordinates with as many as linked_vec_length (the
    square-Jacobian chart), or None where no chart is known (property 6 is
    then skipped for the distribution)."""
    from ..utils import tril_to_vec, triu_to_vec

    if isinstance(u, LeafUnconstrainer):
        kind = u.dist.support.kind
        if kind == "simplex":
            return u.to_vec(x)[..., :-1]
        if kind == "corr":
            return triu_to_vec(x, 1)
        if kind == "pd":
            return tril_to_vec(x)
        if kind == "chol_corr":
            return tril_to_vec(x, 1) if getattr(u.dist, "mode", "L") == "L" else triu_to_vec(x, 1)
        v = u.to_vec(x)
        return v if v.shape[-1] == u.linked_vec_length else None
    if isinstance(u, IIDUnconstrainer):
        inner = _free_chart(u.inner, x)  # over the leading block axis
        return None if inner is None else inner.reshape(tuple(inner.shape[:-2]) + (-1,))
    if isinstance(u, TreeUnconstrainer):
        parts = []
        for c, xi in zip(u.children, u._parts(x)):
            p = _free_chart(c, xi)
            if p is None:
                return None
            parts.append(p)
        return torch.cat(parts, dim=-1)
    if isinstance(u, TransformedUnconstrainer):
        # valid where the whole path keeps the dimension
        return u.to_vec(x) if u.vec_length == u.linked_vec_length else None
    return None


def _check_in_support(u: Unconstrainer, x, atol=None):
    if atol is None:
        dt = _leaves(x)[0].dtype
        atol = max(1e-6, 2e3 * float(torch.finfo(dt).eps))  # about 2.4e-4 in float32
    if isinstance(u, LeafUnconstrainer):
        return bool(u.dist.in_support(x, atol).all())
    if isinstance(u, IIDUnconstrainer):
        return _check_in_support(u.inner, x, atol)
    if isinstance(u, TreeUnconstrainer):
        return all(_check_in_support(c, xi, atol) for c, xi in zip(u.children, u._parts(x)))
    return True  # a transformed distribution's support is the transform's image


def _leaves(x):
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _tree_allclose(a, b, atol, rtol=1e-7):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_np(x), _np(y), atol=atol, rtol=rtol)


def _leaf_ranges(u, vo: int = 0, lo: int = 0):
    """[(vec start, vec length, linked start, linked length)] of each leaf,
    in order."""
    if isinstance(u, IIDUnconstrainer):
        out = []
        for i in range(u.n):
            out.extend(_leaf_ranges(u.inner, vo + i * u.inner.vec_length,
                                    lo + i * u.inner.linked_vec_length))
        return out
    if isinstance(u, TreeUnconstrainer):
        out = []
        for c, (s, _), (ls, _) in zip(u.children, u.offsets, u.linked_offsets):
            out.extend(_leaf_ranges(c, vo + s, lo + ls))
        return out
    return [(vo, u.vec_length, lo, u.linked_vec_length)]


def jacfwd(f, x):
    """The Jacobian of f: R^n -> R^m at x (m, n), column by column through
    `torch.autograd.forward_ad` (the link Functions have `jvp`s but do not
    vmap, so `torch.func.jacfwd` is not the tool)."""
    cols = []
    with fwAD.dual_level():
        for j in range(x.shape[-1]):
            e = torch.zeros_like(x)
            e[j] = 1.0
            cols.append(fwAD.unpack_dual(f(fwAD.make_dual(x, e))).tangent)
    return torch.stack(cols, dim=-1)


def _launch_stability(u, dim, dtype, device):
    """Property 3: two calls of each entry at one shape launch the same
    kernels the same number of times, and the fused evaluation's cache
    keeps at most one entry, for this (dtype, device)."""
    from ..vectorize.fused_kernel import _PREP_CACHE

    y = torch.zeros((4, dim), dtype=dtype, device=device)
    for name, f in (("from_linked_vec", lambda v: u.from_linked_vec(v)),
                    ("linked_logdensity_t", lambda v: u.linked_logdensity_t(v.T.contiguous()))):
        counts = []
        for k in range(2):
            before = dict(kernels.LAUNCHES)
            with torch.no_grad():
                f(y + 0.1 * k)
            counts.append({n: kernels.LAUNCHES[n] - c for n, c in before.items()})
        assert counts[0] == counts[1], f"{name} launched {counts[0]}, then {counts[1]}"
    keys = list(_PREP_CACHE.get(u, {}))
    assert set(keys) <= {(dtype, y.device)}, f"_PREP_CACHE holds {keys} for one (dtype, device)"


def test_all(
    d: Distribution,
    *,
    seed: int = 23,
    n_roundtrip: int = 32,
    n_inverse: int = 16,
    inverse_scale: float = 1.0,
    atol: float = 1e-7,
    check_logjac_ad: bool = True,
    check_optics: bool = True,
    check_logpdf: bool = True,
    check_grad: bool = True,
    skip=(),
):
    """Run the property sweep on distribution `d` (on its parameters'
    device and dtype). Raises on a failure."""
    p0 = first_param(d)
    dtype, device = p0.dtype, p0.device
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    u = unconstrain(d, device=device)

    def vec(a, scale=1.0):
        return torch.as_tensor(a * scale, dtype=dtype, device=device)

    # dtype-aware tolerances: float64 keeps the reference's 1e-5 / 1e-6
    # bars (test_utils.jl:251-254), float32 scales by eps
    eps = float(torch.finfo(dtype).eps)
    rt_tol = max(100.0 * atol, 1e3 * eps)
    ld_tol = max(10.0 * atol, 1e3 * eps)
    dim = u.linked_vec_length

    # 4. static lengths (first: later properties rely on them)
    assert isinstance(u.vec_length, int) and isinstance(dim, int)

    # 1. round trip on samples
    if "roundtrip" not in skip:
        x = d.sample(gen, (n_roundtrip,))
        v = u.to_vec(x)
        assert v.shape[-1] == u.vec_length, (v.shape, u.vec_length)
        _tree_allclose(u.from_vec(v), x, atol=atol)
        lv, ld = u.to_linked_vec(x)
        assert lv.shape[-1] == dim
        assert ld.shape == lv.shape[:-1]
        x_rt, ld_inv = u.from_linked_vec(lv)
        _tree_allclose(x_rt, x, atol=rt_tol, rtol=rt_tol)
        np.testing.assert_allclose(_np(ld_inv), -_np(ld), atol=ld_tol, rtol=ld_tol)

    # 2. inverse round trip from random unconstrained vectors, in support
    if "inverse" not in skip:
        y = vec(rng.standard_normal((n_inverse, dim)), inverse_scale)
        xs, ld = u.from_linked_vec(y)
        assert _check_in_support(u, xs), f"from_linked_vec left the support for {type(d).__name__}"
        y_rt, ld2 = u.to_linked_vec(xs)
        np.testing.assert_allclose(_np(y_rt), _np(y), atol=rt_tol, rtol=rt_tol)
        np.testing.assert_allclose(_np(ld2), -_np(ld), atol=ld_tol, rtol=ld_tol)

    # 3. launch stability (the JAX sweep's trace stability)
    if "trace" not in skip:
        _launch_stability(u, dim, dtype, device)

    # 5. optic provenance and the Jacobian's support, for every case:
    # J is (linked length, vec length), at a valid sample
    if check_optics and "optics" not in skip:
        ov, lov = u.optic_vec(), u.linked_optic_vec()
        assert len(ov) == u.vec_length
        assert len(lov) == dim
        xs, _ = u.from_linked_vec(vec(rng.standard_normal(dim), 0.3))
        xvec = u.to_vec(xs)
        # (a) the plain optics read exactly their slot of to_vec
        for j, o in enumerate(ov):
            np.testing.assert_allclose(_np(torch.as_tensor(o.get(xs))), _np(xvec[j]), rtol=1e-12,
                                       err_msg=f"optic_vec[{j}]={o} does not address slot {j}")
        # (b) row i of d to_linked_vec / d vec touches only the claimed
        # column (a named optic) or its own leaf's columns (None)
        J = _np(jacfwd(lambda vv: u.to_linked_vec(u.from_vec(vv))[0], xvec.detach()))
        tol = 1e-9 * max(1.0, np.abs(J).max())
        ranges = _leaf_ranges(u)
        for i, lo_i in enumerate(lov):
            vs, vl = next((vs, vl) for vs, vl, ls, ll in ranges if ls <= i < ls + ll)
            support = set(np.nonzero(np.abs(J[i]) > tol)[0].tolist())
            if lo_i is None:
                assert support <= set(range(vs, vs + vl)), (
                    f"entangled linked slot {i} leaks outside its leaf: "
                    f"support={sorted(support)} leaf=[{vs},{vs + vl})")
            else:
                j = ov.index(lo_i)
                assert support <= {j}, (
                    f"linked slot {i} claims sole dependence on {lo_i} (col {j}) "
                    f"but depends on {sorted(support)}")

    # 6. the linked log-det against autograd's Jacobian through the chart
    if check_logjac_ad and "logjac" not in skip:
        y = vec(rng.standard_normal(dim), 0.3 * inverse_scale)
        x0, ld0 = u.from_linked_vec(y)
        if _free_chart(u, x0) is not None:
            J = torch.autograd.functional.jacobian(
                lambda yv: _free_chart(u, u.from_linked_vec(yv)[0]), y)
            logdet = torch.linalg.slogdet(J)[1]
            np.testing.assert_allclose(_np(logdet), _np(ld0), atol=ld_tol, rtol=ld_tol,
                                       err_msg="from_linked logdet != slogdet(autograd Jacobian)")

    # 8. gradients of the linked density and of the inverse link's log-det
    # against central differences, with the JAX sweep's step and roundoff
    # floor model: h = (kappa eps (1 + |f|))^(1/3), floor 2 (kappa eps
    # (1 + |f|))^(2/3) (KNOWN_BROKEN.md R3-2)
    if check_grad and "grad" not in skip:
        y = vec(rng.standard_normal(dim), 0.3 * inverse_scale)
        kappa = _measured_kappa(dtype, device)
        gtol = max(1e-6, 200.0 * eps ** (2.0 / 3.0))
        for name, f in (("linked_logdensity", u.linked_logdensity),
                        ("inverse logdet", lambda v: u.from_linked_vec(v)[1])):
            with torch.no_grad():
                f0 = 1.0 + float(f(y[None, :]).abs().max())
            h = (kappa * eps * f0) ** (1.0 / 3.0)
            fd_floor = 2.0 * (kappa * eps * f0) ** (2.0 / 3.0)
            E = torch.eye(dim, dtype=dtype, device=device) * h
            yy = y.detach().requires_grad_(True)
            out = f(yy[None, :]).sum()
            # an identity link's log-det is a constant with no graph
            g = torch.autograd.grad(out, yy)[0] if out.requires_grad else torch.zeros_like(y)
            with torch.no_grad():
                fd = _np((f(y + E) - f(y - E)) / (2.0 * h))
            np.testing.assert_allclose(
                _np(g), fd, atol=gtol * (1.0 + np.abs(fd).max()) + fd_floor, rtol=gtol,
                err_msg=(f"grad({name}) disagrees with central differences for "
                         f"{type(d).__name__} (a zero-gradient link rule?)"))

    # 9. the whole Jacobian of the inverse link: forward mode == reverse
    # mode, and both == central differences element by element
    if check_grad and "jacobian" not in skip:
        y = vec(rng.standard_normal(dim), 0.3 * inverse_scale)

        def gvec(v):
            return u.to_vec(u.from_linked_vec(v)[0])

        Jf = _np(jacfwd(gvec, y))
        Jr = _np(torch.autograd.functional.jacobian(gvec, y))
        np.testing.assert_allclose(
            Jf, Jr, atol=max(1e-12, 10.0 * eps) * (1.0 + np.abs(Jf).max()), rtol=100.0 * eps,
            err_msg=(f"forward-mode != reverse-mode Jacobian of from_linked_vec for "
                     f"{type(d).__name__} (a wrong jvp or backward rule?)"))
        kappa = _measured_kappa(dtype, device)
        with torch.no_grad():
            f0 = 1.0 + float(gvec(y).abs().max())
            h = (kappa * eps * f0) ** (1.0 / 3.0)
            fd_floor = 2.0 * (kappa * eps * f0) ** (2.0 / 3.0)
            gtol = max(1e-6, 200.0 * eps ** (2.0 / 3.0))
            E = torch.eye(dim, dtype=dtype, device=device) * h
            Jfd = _np((gvec(y + E) - gvec(y - E)) / (2.0 * h)).T
        np.testing.assert_allclose(
            Jf, Jfd, atol=gtol * (1.0 + np.abs(Jfd).max()) + fd_floor, rtol=gtol,
            err_msg=(f"autograd Jacobian of from_linked_vec disagrees with central "
                     f"differences for {type(d).__name__}"))

    # 7. logpdf_with_trans consistency through the unconstrainer
    if (check_logpdf and "logpdf" not in skip
            and isinstance(u, LeafUnconstrainer)):
        from ..registry import logpdf_with_trans

        x = d.sample(torch.Generator(device=device).manual_seed(seed + 1))
        _, ld = u.to_linked_vec(x)
        lp = d.logpdf(x)
        if lp.ndim > 0:
            lp = lp.sum()  # a scalar-event family's elementwise logpdf
        np.testing.assert_allclose(float(lp - ld), float(logpdf_with_trans(d, x, True)),
                                   atol=ld_tol, rtol=ld_tol)
    return True


test_all.__test__ = False  # the harness, not a pytest case
