"""The PD log-density kernel's half-warp design (#11,
`csrc/pd_logdensity.cu`) against the JAX package.

The CUDA kernel runs only on the card, where chip_smoke.py holds it to its
plain version. Here a float64 emulation of its order of operations is held
against the JAX Pallas kernel `pd_logdensity_pallas` in interpret mode, in
both of its layouts (`pre_t`), and against the port's plain version,
float64 at VAL_TOL (the same algebra in another order). In the kernel
lane l of a half-warp owns row l of L:

  dot:   tr = sum_a C_aa |L_a|^2 + sum_{a<b} (C_ab + C_ba) L_a.L_b; lane l
         takes |L_l|^2 (k ascending) times C_ll, then the pairs
         (l, l + d mod 16), d = 1..8 (d = 8 on lanes l < 8 only), each dot
         product over k = 0 .. 15 - d ascending;
  solve: lane l forms column l of A = L^-1 C by forward substitution
         (k ascending) and takes sum_i A_il^2 (i ascending);

the lanes' shares are summed by link_tiles.cuh's group_sum (the xor
butterfly over 16 lanes), and lane 0 sums logJ and sum y_rr in row order.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_links import VAL_TOL
from test_torch_pd import _C, _layout, _y
from test_torch_pd_tiles import _unpack

from tpu_bijectors.kernels.pd import pd_logdensity_pallas

from tpu_bijectors_torch.kernels import pd as kpd

LANES = 16
LOG2 = np.log(2.0)


def group_sum(v):
    """link_tiles.cuh's group_sum over 16 lanes: v_l += v_{l xor o} for
    o = 8, 4, 2, 1; lane 0's sum."""
    v = list(v)
    for o in (8, 4, 2, 1):
        v = [v[i] + v[i ^ o] for i in range(LANES)]
    return v[0]


def lane_shares(L, einv, C, mode):
    """Each lane's share of the trace for one element, in the kernel's order."""
    K = L.shape[0]
    rows = np.zeros((LANES, LANES))
    rows[:K, :K] = L
    t = np.zeros(LANES)
    for lane in range(K):
        if mode == "dot":
            x0 = 0.0
            for k in range(LANES):
                x0 += rows[lane, k] * rows[lane, k]
            t[lane] = C[lane, lane] * x0
            for d in range(1, 9):
                b = (lane + d) % LANES
                if b >= K or (d == 8 and lane >= 8):
                    continue  # not this lane's pair
                x = 0.0
                for k in range(LANES - d):
                    x += rows[lane, k] * rows[b, k]
                t[lane] += (C[lane, b] + C[b, lane]) * x
        else:
            a = np.zeros(K)
            for i in range(K):
                x = C[i, lane]
                for k in range(i):
                    x -= L[i, k] * a[k]
                a[i] = x * einv[i]
            for i in range(K):
                t[lane] += a[i] * a[i]
    return t


def half_warp_logdensity(y, K, C, mode):
    """(logJ, sum y_rr, trace), each (B,), in the half-warp design's order."""
    out = np.zeros((3, y.shape[0]))
    for n in range(y.shape[0]):
        L, einv = _unpack(y[n], K)
        lj = sd = 0.0
        for r in range(K):
            yd = y[n, r * (r + 1) // 2 + r]
            lj += (K + 1.0 - r) * yd
            sd += yd
        out[:, n] = lj + K * LOG2, sd, group_sum(lane_shares(L, einv, C, mode))
    return out


@functools.lru_cache(maxsize=None)
def _jax_kernel(K, mode, pre_t):
    """The JAX kernel in interpret mode, jitted once per K, mode and layout."""
    return jax.jit(functools.partial(pd_logdensity_pallas, K=K, mode=mode, pre_t=pre_t,
                                     interpret=True))


@pytest.mark.parametrize("layout, pre_t", [("batch", False), ("swapped", True)])
@pytest.mark.parametrize("mode", kpd.MODES)
@pytest.mark.parametrize("K", [1, 2, 4])
def test_half_warp_order_matches_jax_kernel_and_plain(K, mode, layout, pre_t):
    rng = np.random.default_rng(K)
    y, C = _y(rng, K)[:8], _C(rng, K, mode)
    got = half_warp_logdensity(y, K, C, mode)
    ref = _jax_kernel(K, mode, pre_t)(y.T if pre_t else y, C=C)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **VAL_TOL)
    plain = kpd.pd_logdensity_plain(_layout(y, layout), K, torch.as_tensor(C), mode)
    for g, r in zip(got, plain):
        np.testing.assert_allclose(g, r.numpy(), **VAL_TOL)


@pytest.mark.parametrize("mode", kpd.MODES)
@pytest.mark.parametrize("K", [5, 15, 16])
def test_half_warp_order_matches_plain_at_the_kernels_k(K, mode):
    """At the K the kernel runs on the card (the JAX kernel in interpret mode
    is held to it at K <= 4 above): the emulation against the plain
    version, with an unsymmetric C in dot mode (the kernel takes
    (C + C') / 2 itself)."""
    rng = np.random.default_rng(100 + K)
    y, C = _y(rng, K)[:4], _C(rng, K, mode)
    if mode == "dot":
        C = C + 0.1 * np.triu(rng.standard_normal((K, K)), 1)
    got = half_warp_logdensity(y, K, C, mode)
    plain = kpd.pd_logdensity_plain(torch.as_tensor(y), K, torch.as_tensor(C), mode)
    for g, r in zip(got, plain):
        np.testing.assert_allclose(g, r.numpy(), **VAL_TOL)


def test_group_sum_is_the_xor_butterfly():
    """The emulated group_sum adds every lane's share once: lane 0 holds
    the sum of all 16 (powers of two, so any order is exact)."""
    v = [2.0 ** i for i in range(LANES)]
    assert group_sum(v) == sum(v)
