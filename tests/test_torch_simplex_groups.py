"""The simplex inverse's small-batch design (`csrc/simplex_inv.cu`, a group
of G lanes an element) against the JAX package, and its choice by batch.

The CUDA kernel runs only on the card, where chip_smoke.py holds it to its
plain version. Here a float64 numpy emulation of its order of operations
(lane l takes the coordinates l, l + G, ... of each chunk of G; every lane
walks the serial chain on the chunk's z; each lane sums its log-det terms
(each one log of the product of the plain version's three floors) and
wlog terms in k order, then the group sums the lanes by the xor butterfly
of link_tiles.cuh's group_sum) is held against the JAX Pallas kernels in
interpret mode and against the port's plain version, float64 at VAL_TOL
(the same algebra; the sums in another order). And the wrappers' design
choice: `simplex_design` at its boundary, the launch key and the design
flag each design hands the kernel (recorded off the CPU, on meta tensors,
with the launch replaced), and a CPU tensor still runs the plain version
and launches nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_links import VAL_TOL, _inputs

from tpu_bijectors.kernels.simplex import (
    simplex_inverse_logdet_pallas,
    simplex_inverse_logdet_wlog_pallas,
)

from tpu_bijectors_torch import kernels
from tpu_bijectors_torch.kernels import simplex as ks

EPS = np.finfo(np.float64).eps
# the JAX kernels in interpret mode, jitted once: each shape compiles once,
# and the two scales of a K share it
_JAX_INVERSE = jax.jit(functools.partial(simplex_inverse_logdet_pallas, interpret=True))
_JAX_INVERSE_WLOG = jax.jit(functools.partial(simplex_inverse_logdet_wlog_pallas, interpret=True))


def group_lanes(Km1):
    """The lanes owning one element: a half-warp while K-1 <= 16, else a
    warp (link_tiles.cuh's group_lanes of K-1)."""
    return 16 if Km1 <= 16 else 32


def group_sum(v):
    """link::group_sum over the lanes v (G,): v_l += v_{l xor o} for
    o = G/2, ..., 1; every lane ends with the same sum, lane 0's is kept."""
    v = v.copy()
    lanes = np.arange(v.size)
    o = v.size // 2
    while o > 0:
        v = v + v[lanes ^ o]
        o //= 2
    return v[0]


def group_inverse(y, am1):
    """(x (B, K), ld (B,), wlog (B,)) in the small design's order."""
    B, Km1 = y.shape
    K, G = Km1 + 1, group_lanes(Km1)
    z = 1.0 / (1.0 + np.exp(-(y - np.log(np.arange(Km1, 0, -1)))))
    x = np.zeros((B, K))
    ld, wlog = np.zeros(B), np.zeros(B)
    for b in range(B):
        s = 0.0
        pre = np.zeros(K)  # s_k, the running sum before step k
        for k in range(Km1):
            pre[k] = s
            if k == 0:
                xk = min(max((z[b, k] - EPS) / (1 - 2 * EPS), 0.0), 1.0)
            else:
                xk = min(max(((1 + EPS) - s) / (1 - 2 * EPS) * z[b, k] - EPS, 0.0), 1.0)
            x[b, k] = xk
            s += xk
        x[b, Km1] = min(max(1.0 - s, 0.0), 1.0)
        lp, wl = np.zeros(G), np.zeros(G)  # each lane's terms in k order
        for k in range(K):
            lane = k % G
            xk = x[b, k]
            # the three logs of a term as one log of their product
            if k == 0:
                lp[lane] += np.log(max(xk, EPS) * max(1.0 - xk, EPS))
            elif k < Km1:
                rem = max(1.0 - pre[k], EPS)
                zl = xk / rem
                lp[lane] += np.log(max(zl, EPS) * max(1.0 - zl, EPS) * rem)
            wl[lane] += am1[k] * np.log(xk + EPS)
        ld[b], wlog[b] = group_sum(lp), group_sum(wl)
    return x, ld, wlog


@pytest.mark.parametrize("scale", [1.5, 1e10])
@pytest.mark.parametrize("K", [2, 3, 16, 17, 33])
def test_group_order_matches_jax_kernels_and_plain(rng, K, scale):
    y = _inputs(rng, 12, K - 1, scale)
    am1 = rng.uniform(0.0, 3.0, K)
    with np.errstate(over="ignore", divide="ignore"):
        x, ld, wlog = group_inverse(y, am1)
    xj, ldj = _JAX_INVERSE(jnp.asarray(y))
    xw, ldw, wlj = _JAX_INVERSE_WLOG(jnp.asarray(y), jnp.asarray(am1))
    for got, ref in ((x, xj), (ld, ldj), (x, xw), (ld, ldw), (wlog, wlj)):
        np.testing.assert_allclose(got, np.asarray(ref), **VAL_TOL)
    xp, ldp, wlp = ks.simplex_inverse_logdet_plain(torch.as_tensor(y), torch.as_tensor(am1))
    # the plain version's logistic is torch.sigmoid, the kernel's 1 / (1 + e^-t)
    np.testing.assert_allclose(x, xp.numpy(), **VAL_TOL)
    np.testing.assert_allclose(ld, ldp.numpy(), **VAL_TOL)
    np.testing.assert_allclose(wlog, wlp.numpy(), **VAL_TOL)


def test_simplex_design_at_its_boundary():
    assert ks.simplex_design(1) == "small"
    assert ks.simplex_design(64) == "small"
    assert ks.simplex_design(ks.SMALL_B) == "small"
    assert ks.simplex_design(ks.SMALL_B + 1) == "wide"
    assert ks.simplex_design(131072) == "wide"


@pytest.mark.parametrize("B", [64, ks.SMALL_B, ks.SMALL_B + 1])
def test_wrappers_hand_the_kernel_the_design_of_the_batch(monkeypatch, B):
    """Off the CPU each wrapper launches once, under the key of its design,
    with the design flag the C entry reads; a design named by the caller
    wins, and an unknown one raises before any launch."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda fn, name, dev, *args: calls.append(
        (fn, name, args)))
    y = torch.zeros((B, 15), device="meta")
    am1 = torch.zeros(16, device="meta")
    small = ks.simplex_design(B) == "small"
    ks.simplex_inverse_logdet(y, am1)
    ks.simplex_inverse(y)
    ks.simplex_inverse_logdet(y, am1, design="wide" if small else "small")
    (fn7, name7, args7), (fn8, name8, args8), (_, name_o, args_o) = calls
    assert fn7 == "tbt_simplex_inverse_logdet" and fn8 == "tbt_simplex_inverse"
    assert name7 == ("simplex_inverse_logdet_small" if small else "simplex_inverse_logdet")
    assert name8 == "simplex_inverse"
    assert args7[-3:] == (15, int(small), B) and args8[-3:] == (15, int(small), B)
    assert name_o != name7 and args_o[-2] == int(not small)
    with pytest.raises(ValueError, match="design must be one of"):
        ks.simplex_inverse_logdet(y, am1, design="thread")
    assert len(calls) == 3


@pytest.mark.parametrize("design", [None, "small", "wide"])
def test_cpu_tensors_run_plain_and_launch_nothing(rng, design):
    before = dict(kernels.LAUNCHES)
    y = torch.as_tensor(_inputs(rng, 40, 15, 1.0))
    am1 = torch.as_tensor(rng.uniform(0.0, 3.0, 16))
    got = ks.simplex_inverse_logdet(y, am1, design=design)
    for g, r in zip(got, ks.simplex_inverse_logdet_plain(y, am1)):
        assert torch.equal(g, r)
    assert torch.equal(ks.simplex_inverse(y, design=design), ks.simplex_inverse_plain(y))
    assert kernels.LAUNCHES == before
