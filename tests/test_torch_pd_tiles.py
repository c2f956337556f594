"""The PD trace gradient's half-warp design (`csrc/pd_tiles.cuh`, run by
#12 `csrc/pd_trace_grad.cu` and by #2's PD items) against the JAX package.

The CUDA kernel runs only on the card, where chip_smoke.py holds it to its
plain version. Here a float64 numpy emulation of its order of operations
(lane l owns row and column l: dot mode forms column l of M = C L summed
over b ascending; solve mode forms column l of A = L^-1 C by forward
substitution and of At = L^-T A by back substitution, and reads
G_rl = sum_j At_rj A_lj, j ascending, from the two tiles; each slot times
L_rr on the diagonal) is held against the JAX Pallas kernel in interpret
mode, in both of its layouts (`pre_t`), and against the port's plain
version, float64 at VAL_TOL (the same algebra in another order). And the
wrapper still refuses K > MAX_K off the CPU.

The JAX kernel in interpret mode costs minutes at K = 16 (tracing and
compiling its unrolled body, whatever the batch: jitting it saves
nothing, and no two cases share a kernel), so the module computes every
case's reference once, before the cases run, the two costliest in worker
processes beside the rest (`references`).
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_links import VAL_TOL
from test_torch_pd import _C, _layout, _y

from tpu_bijectors.kernels.pd import pd_trace_grad_pallas

from tpu_bijectors_torch.kernels import pd as kpd

KS = (1, 2, 5, 16)
LAYOUTS = (("batch", False), ("swapped", True))


def _unpack(y, K):
    """L (K, K) and exp(-y_rr) (K,) of one element's packed y."""
    L = np.zeros((K, K))
    einv = np.zeros(K)
    for r in range(K):
        base = r * (r + 1) // 2
        L[r, :r] = y[base: base + r]
        L[r, r] = np.exp(y[base + r])
        einv[r] = np.exp(-y[base + r])
    return L, einv


def half_warp_trace_grad(y, K, C, mode):
    """g (B, P) in the half-warp design's order of operations, lane by lane."""
    C = 0.5 * (C + C.T) if mode == "dot" else C
    g = np.zeros_like(y)
    for n in range(y.shape[0]):
        L, einv = _unpack(y[n], K)
        G = np.zeros((K, K))  # G[r, l]: the slot (r, l) of lane l, r >= l
        if mode == "dot":
            for lane in range(K):
                m = np.zeros(K)  # column `lane` of M = C L
                for a in range(K):
                    acc = 0.0
                    for b in range(K):
                        acc += C[a, b] * L[b, lane]
                    m[a] = acc
                G[lane:, lane] = 2.0 * m[lane:]
        else:
            A, At = np.zeros((K, K)), np.zeros((K, K))  # the two tiles
            for lane in range(K):
                a = np.zeros(K)
                for i in range(K):
                    x = C[i, lane]
                    for k in range(i):
                        x -= L[i, k] * a[k]
                    a[i] = x * einv[i]
                at = np.zeros(K)
                for i in range(K - 1, -1, -1):
                    x = a[i]
                    for k in range(i + 1, K):
                        x -= L[k, i] * at[k]
                    at[i] = x * einv[i]
                A[:, lane], At[:, lane] = a, at
            for lane in range(K):
                for r in range(lane, K):
                    acc = 0.0
                    for j in range(K):
                        acc += At[r, j] * A[lane, j]
                    G[r, lane] = -2.0 * acc
        for r in range(K):
            G[r, r] *= L[r, r]
            g[n, r * (r + 1) // 2: r * (r + 1) // 2 + r + 1] = G[r, : r + 1]
    return g


def _inputs(K, mode):
    """The case's y (8, P) and C, from numpy seed K."""
    rng = np.random.default_rng(K)
    return _y(rng, K)[:8], _C(rng, K, mode)


def _reference(K, mode, pre_t):
    """The JAX kernel's d tr / d y on the case's inputs, in interpret mode,
    in the layout of pre_t. In a worker process it first sets what
    conftest.py sets."""
    if not jax.config.jax_enable_x64:  # a worker process: conftest.py's settings
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    y, C = _inputs(K, mode)
    yj = jnp.asarray(y.T if pre_t else y)
    return np.asarray(pd_trace_grad_pallas(yj, K, jnp.asarray(C), mode, pre_t=pre_t,
                                           interpret=True))


@pytest.fixture(scope="module")
def references():
    """(K, mode, pre_t) -> the JAX kernel's output, for every case: the two
    costliest (K = 16, solve mode: minutes each) in two worker processes,
    the rest here meanwhile (where no process can be started, here as
    well)."""
    cases = [(K, m, p) for K in KS for m in kpd.MODES for _, p in LAYOUTS]
    heavy = [c for c in cases if c[0] == 16 and c[1] == "solve"]
    out = {}
    try:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(len(heavy), mp_context=ctx) as pool:
            futures = {c: pool.submit(_reference, *c) for c in heavy}
            out.update({c: _reference(*c) for c in cases if c not in futures})
            out.update({c: f.result() for c, f in futures.items()})
    except (OSError, BrokenProcessPool):
        out.update({c: _reference(*c) for c in cases if c not in out})
    return out


@pytest.mark.parametrize("layout, pre_t", LAYOUTS)
@pytest.mark.parametrize("mode", kpd.MODES)
@pytest.mark.parametrize("K", KS)
def test_half_warp_order_matches_jax_kernel_and_plain(references, K, mode, layout, pre_t):
    y, C = _inputs(K, mode)
    got = half_warp_trace_grad(y, K, C, mode)
    ref = references[K, mode, pre_t]
    np.testing.assert_allclose(got, ref.T if pre_t else ref, **VAL_TOL)
    plain = kpd.pd_trace_grad_plain(_layout(y, layout), K, torch.as_tensor(C), mode)
    np.testing.assert_allclose(got, plain.numpy(), **VAL_TOL)


@pytest.mark.parametrize("mode", kpd.MODES)
def test_pd_trace_grad_beyond_the_kernels_k_raises_off_the_cpu(monkeypatch, mode):
    """K = 17 > MAX_K off the CPU: the trace gradient (and the log-density
    it is the backward of) raise, naming the limit, and no plain version
    runs there; on the CPU the plain version still serves that K."""
    K = 17
    assert K == kpd.MAX_K + 1
    P = K * (K + 1) // 2
    y = torch.zeros((2, P), device="meta")
    C = torch.eye(K, device="meta")

    def no_plain(*args, **kw):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(kpd, "pd_trace_grad_plain", no_plain)
    monkeypatch.setattr(kpd, "pd_logdensity_plain", no_plain)
    match = f"1 <= K <= {kpd.MAX_K}; got K = 17"
    with pytest.raises(ValueError, match=match):
        kpd.pd_trace_grad(y, K, C, mode)
    with pytest.raises(ValueError, match=match):
        kpd.pd_logdensity(y, K, C, mode)
    monkeypatch.undo()
    g = kpd.pd_trace_grad(torch.zeros((1, P), dtype=torch.float64), K,
                          torch.eye(K, dtype=torch.float64), mode)
    assert g.shape == (1, P) and bool(torch.isfinite(g).all())
