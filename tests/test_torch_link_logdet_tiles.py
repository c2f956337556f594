"""The LKJ log-det #5 (`csrc/lkj_logdet.cu`) and the simplex forward link #9
(`csrc/simplex_fwd.cu`): their designs' order of operations and tile
partition, against the JAX package.

The CUDA kernels run only on the card, where chip_smoke.py holds them to
their plain versions. Here, on the CPU:

- a numpy float32 emulation of each kernel's per-element order of
  operations (#5: the two running sums slot by slot, logJ += lr (1 + c_j)
  at a column's end as one fused multiply-add; #9: the prefix sum, y with
  the products rounded apart, ld as one log of each coordinate's three
  factors), which every design of a kernel shares;
- an emulation of the staged designs' tiles: the block shape and grid the
  host picks, the tiles each block walks (the partial last one among
  them), the indices the staging loops gather from each of the three
  layouts (the slice of a batch-major state, a contiguous tensor, the
  swapped view of a transposed state) and the indices the output tiles
  scatter to, so that the staged results equal the direct ones bit for
  bit; and each kernel's choice of design, from the constants parsed
  from the sources;
- those emulations and the port's plain versions against
  `lkj_logdet_pallas` / `simplex_forward_logdet_pallas` in interpret mode
  at K <= 8 and against the JAX jnp paths at K = 16: seeded states,
  points on the simplex's faces and |y| ~ 1e10. Tolerances: the float32
  emulation at RTOL_SUM of the magnitude (chip_smoke.py's bound for these
  sums) of a float64 reference for #5 on the same float32 inputs, plus an
  ulp of log 2 for each logcosh summed where they cancel to near 0, and of
  a float32 reference for #9 (whose eps algebra is the dtype's), y at
  ATOL_LOGIT of its conditioning (`chip_smoke.fwd_y_scale`); the float64
  plain versions against float64 JAX at VAL_TOL (the same algebra).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batch_major import _simplex_points
from test_torch_links import VAL_TOL, _inputs

import chip_smoke
from tpu_bijectors.bijectors import corr as jcorr
from tpu_bijectors.bijectors import simplex as jsimplex
from tpu_bijectors.kernels.lkj import lkj_logdet_pallas
from tpu_bijectors.kernels.simplex import simplex_forward_logdet_pallas

from tpu_bijectors_torch import kernels
from tpu_bijectors_torch.kernels import lkj as kl
from tpu_bijectors_torch.kernels import simplex as ks

CSRC = Path(kl.__file__).resolve().parent / "csrc"
F32 = np.float32
EPS32 = F32(np.finfo(np.float32).eps)
LOG2 = F32(0.693147180559945309)
SMS, OPTIN = 132, 232448  # the H100's SMs and a block's opt-in shared memory
RTOL_SUM, ATOL_LOGIT = chip_smoke.RTOL_SUM, chip_smoke.ATOL_LOGIT

_JAX_LKJ = {
    chol: jax.jit(functools.partial(lkj_logdet_pallas, chol=chol, interpret=True),
                  static_argnums=1)
    for chol in (False, True)
}
_JAX_FWD = jax.jit(functools.partial(simplex_forward_logdet_pallas, interpret=True))


def constants(source):
    """name -> value of the source's integral `constexpr` constants."""
    text = (CSRC / source).read_text()
    return {m[0]: int(m[1]) for m in re.findall(
        r"constexpr (?:int|long long) (\w+) = (\d+);", text)}


LKJ_C = constants("lkj_logdet.cu")
FWD_C = constants("simplex_fwd.cu")


def close(got, ref, rtol, scale=None, floor=0.0):
    """|got - ref| <= rtol * scale + floor, scale |ref| + 1e-3 max|ref| by
    default (chip_smoke.check's)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if scale is None:
        scale = np.abs(ref) + 1e-3 * np.abs(ref).max()
    assert np.all(np.isfinite(got))
    np.testing.assert_array_less(np.abs(got - ref), rtol * scale + floor + 1e-300)


def cancel_floor(terms):
    """The absolute error of a float32 sum of `terms` logcosh near 0, each
    |y| + softplus(-2|y|) - log 2 carrying an ulp of log 2 from the
    cancellation (float64 references have none)."""
    return 2.0 * terms * float(np.spacing(LOG2))


# ---------------------------------------------------------------------------
# the per-element order of operations
# ---------------------------------------------------------------------------


def fma32(a, b, c):
    """float32 fused multiply-add: a b exact in float64, one rounding."""
    return (a.astype(np.float64) * b + c).astype(F32)


def logcosh32(y):
    a = np.abs(y.astype(F32))
    return (a + np.log1p(np.exp(F32(-2.0) * a))) - LOG2


def lkj_walk(lc, K, chol):
    """(logJ, log diag W) from the logcosh of each slot, lc (B, P) float32,
    in the kernels' order: lr -= lc; lj += lr a slot, then log W_jj = lr and
    lj += lr (1 + c_j) a column."""
    B = lc.shape[0]
    lj = np.zeros(B, F32)
    ldw = np.zeros((B, K), F32)
    slot = 0
    for j in range(1, K):
        lr = np.zeros(B, F32)
        for _ in range(j):
            lr = lr - lc[:, slot]
            lj = lj + lr
            slot += 1
        ldw[:, j] = lr
        lj = fma32(lr, 1.0 if chol else float(K - j), lj)
    return lj, ldw


def lkj_emulated(y, K, chol):
    return lkj_walk(logcosh32(np.asarray(y, F32)), K, chol)


def forward_emulated(x):
    """(y (B, K-1), ld (B,)) of #9 in float32, in the kernel's order."""
    x = np.asarray(x, F32)
    B, K = x.shape
    c12, c1p = F32(1) - F32(2) * EPS32, F32(1) + EPS32
    lc = np.log(np.arange(K - 1, 0, -1)).astype(F32)
    y = np.zeros((B, K - 1), F32)

    def mx(a):
        return np.where(np.isnan(a) | (a > EPS32), a, EPS32).astype(F32)

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        x0 = x[:, 0]
        z0 = x0 * c12 + EPS32
        lp = np.log(mx(x0) * mx(F32(1) - x0))
        y[:, 0] = (np.log(z0) - np.log1p(-z0)) + lc[0]
        s = x0
        for k in range(1, K - 1):
            xk = x[:, k]
            zf = ((xk + EPS32) * c12) / (c1p - s)
            rem = mx(F32(1) - s)
            zl = xk / rem
            lp = lp + np.log((mx(zl) * mx(F32(1) - zl)) * rem)
            y[:, k] = (np.log(zf) - np.log1p(-zf)) + lc[k]
            s = s + xk
    return y, -lp


# ---------------------------------------------------------------------------
# the staged designs' tiles
# ---------------------------------------------------------------------------


def lkj_staged_shape(K, B):
    """(E, threads) of csrc/lkj_logdet.cu::staged_shape and staged_threads:
    E = 0 where a warp of elements does not fit."""
    P = K * (K - 1) // 2
    Pp, Fs, nt = P | 1, K | 1, LKJ_C["kThreads"]

    def nbytes(E):  # link::Shape::bytes with one K x K-free tile: the out tile
        return 4 * E * (Fs + 2 * Pp)

    E = nt
    while E > 32 and nbytes(E) > OPTIN // LKJ_C["kBlocksPerSm"]:
        E //= 2
    if nbytes(E) > OPTIN:
        return 0, 0
    while E > 1 and -(-B // E) < SMS:
        E //= 2
    t = 32
    while t < nt and t < E * Pp:
        t *= 2
    return E, t


def fwd_staged_shape(K):
    """E (= threads) of csrc/simplex_fwd.cu::staged_shape; 0 below a warp."""
    Km1 = K - 1
    E = FWD_C["kWideThreads"]
    while E >= 32 and 4 * E * ((Km1 | 1) + 2 * (Km1 | 1)) > OPTIN:
        E //= 2
    return E if E >= 32 else 0


def lkj_design(K, B):
    """The design tbt_lkj_logdet launches: 'staged', 'unrolled' (direct,
    K <= kMaxUnrolledDirect) or 'ahead' (direct, loads ahead)."""
    if K > LKJ_C["kMaxUnrolledDirect"] and B < LKJ_C["kDirectMinB"]:
        if lkj_staged_shape(K, B)[0] > 0:
            return "staged"
    return "unrolled" if 2 <= K <= LKJ_C["kMaxUnrolledDirect"] else "ahead"


def fwd_design(K, B):
    return "staged" if B >= FWD_C["kStagedMinB"] and fwd_staged_shape(K) > 0 else "direct"


def tiles_of(B, E, grid):
    """[(block, t, b0, n)] in the order each block walks its tiles."""
    ntiles = -(-B // E)
    return [(blk, t, t * E, min(E, B - t * E))
            for blk in range(min(ntiles, grid)) for t in range(blk, ntiles, grid)]


def prefetch_rows_pairs(n, P, nt):
    """(e, q) of each cp.async of link::prefetch_rows, stepping (e, q) by nt
    from two divisions a thread, as the kernel does."""
    pairs = []
    for tid in range(min(nt, n * P)):
        e, q = divmod(tid, P)
        de, dq = divmod(nt, P)
        for _ in range(tid, n * P, nt):
            pairs.append((e, q))
            e, q = e + de, q + dq
            if q >= P:
                e, q = e + 1, q - P
    return pairs


def prefetch_y_pairs(n, P, E, nt, swapped):
    """(e, q) of each cp.async of link::prefetch_y: along the batch for the
    swapped view (thread tid: element tid % E), else a warp an element."""
    if swapped:
        return [(tid % E, q) for tid in range(nt) if tid % E < n
                for q in range(tid // E, P, nt // E)]
    return [(e, q) for tid in range(nt) for e in range(tid // 32, n, nt // 32)
            for q in range(tid % 32, P, 32)]


def store_rows_pairs(n, w, nt):
    """(e, c) of the tile read for each output float of link::store_rows
    into a contiguous (B, w) tensor, in output order from b0 w on: 16-byte
    stores of four floats (one division for the four), then the rest."""
    total = n * w
    q0 = total & ~3
    out = {}
    for tid in range(nt):
        for q in range(4 * tid, q0, 4 * nt):
            e, c = divmod(q, w)
            for j in range(4):
                out[q + j] = (e, c)
                c += 1
                if c == w:
                    e, c = e + 1, 0
        for q in range(q0 + tid, total, nt):
            out[q] = divmod(q, w)
    return [out[q] for q in range(total)]


LAYOUTS = ("batch-major slice", "contiguous", "swapped")


def flat_layout(v, rows, lay):
    """The rows of a batch-major (B, D) state v in one of the three layouts,
    as the kernel sees it: (flat buffer, base offset, sb, sp)."""
    B, D = v.shape
    P = rows.stop - rows.start
    if lay == "batch-major slice":
        return v.reshape(-1), rows.start, D, 1
    if lay == "contiguous":
        return np.ascontiguousarray(v[:, rows]).reshape(-1), 0, P, 1
    return np.ascontiguousarray(v.T).reshape(-1), rows.start * B, 1, B


def staged_gather(buf, base, sb, sp, B, P, E, nt, grid, flat):
    """Every tile's staged slots gathered by the prefetch loops, checked
    to cover each of the tile's (e, q) once and nothing else; returns the
    (B, P) float32 array of y as the staged tiles hold it."""
    out = np.full((B, P), np.nan, F32)
    seen = np.zeros(B, int)
    for _, _, b0, n in tiles_of(B, E, grid):
        if flat and sp == 1 and sb != 1:
            pairs = prefetch_rows_pairs(n, P, nt)
        else:
            pairs = prefetch_y_pairs(n, P, E, nt, sb == 1 and sp != 1)
        assert sorted(pairs) == [(e, q) for e in range(n) for q in range(P)]
        e, q = np.array(pairs).T
        out[b0 + e, q] = buf[base + (b0 + e) * sb + q * sp]
        seen[b0 : b0 + n] += 1
    assert np.all(seen == 1)
    return out


# the grids the staged tests take: a few blocks, so that each walks several
# tiles and the last is partial
GRIDS = (1, 3)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("K,chol,B", [(3, False, 700), (9, True, 200), (16, False, 150),
                                      (16, True, 1000), (17, False, 75)])
def test_lkj_staged_tiles_equal_the_direct_walk(rng, K, chol, B, lay, grid):
    """The staged design at the shape the host picks: the tiles' y gathered
    from the layout's strides, the block's logcosh of the staged slots, each
    thread's walk, and log diag W scattered from the out tile by
    store_rows, bit for bit the direct design's walk of y."""
    P = K * (K - 1) // 2
    rows = slice(4, 4 + P)
    v = _inputs(rng, B, P + 9, 0.7).astype(F32)
    buf, base, sb, sp = flat_layout(v, rows, lay)
    E, nt = lkj_staged_shape(K, B)
    assert E > 0 and nt >= E and nt & (nt - 1) == 0
    staged = staged_gather(buf, base, sb, sp, B, P, E, nt, grid, True)
    np.testing.assert_array_equal(staged, v[:, rows])
    lj, ldw_rows = lkj_walk(logcosh32(staged), K, chol)
    ldw = np.full((B, K), np.nan, F32)
    for _, _, b0, n in tiles_of(B, E, grid):
        for q, (e, c) in enumerate(store_rows_pairs(n, K, nt)):
            ldw.reshape(-1)[b0 * K + q] = ldw_rows[b0 + e, c]
    ref = lkj_emulated(v[:, rows], K, chol)
    np.testing.assert_array_equal(lj, ref[0])
    np.testing.assert_array_equal(ldw, ref[1])


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("K,B", [(2, 1500), (16, 1100), (17, 1300)])
def test_fwd_staged_tiles_equal_the_direct_walk(rng, K, B, lay):
    """#9's staged design: x_0 .. x_{K-2} gathered by the prefetch loops
    (x_{K-1} never loaded), y scattered from the y tile by store_rows, bit
    for bit the direct walk of x."""
    rows = slice(3, 3 + K)
    v = np.zeros((B, K + 7), F32)
    v[:, rows] = _simplex_points(rng, B, K, 1.0)
    buf, base, sb, sp = flat_layout(v, rows, lay)
    E = fwd_staged_shape(K)
    staged = staged_gather(buf, base, sb, sp, B, K - 1, E, E, 3, True)
    np.testing.assert_array_equal(staged, v[:, 3 : 2 + K])
    full = np.concatenate([staged, np.full((B, 1), np.nan, F32)], axis=1)
    y_rows, ld = forward_emulated(full)
    y = np.full((B, K - 1), np.nan, F32)
    for _, _, b0, n in tiles_of(B, E, 3):
        for q, (e, c) in enumerate(store_rows_pairs(n, K - 1, E)):
            y.reshape(-1)[b0 * (K - 1) + q] = y_rows[b0 + e, c]
    ref = forward_emulated(v[:, rows])
    np.testing.assert_array_equal(y, ref[0])
    np.testing.assert_array_equal(ld, ref[1])


def test_designs_by_batch_and_k():
    """Each kernel's design at the boundaries of its constants: #5 unrolled
    and direct to K = 8, then staged below kDirectMinB elements (down to one
    element a block at a small batch) until a warp of elements no longer
    fits (K = 43), with its loads ahead from kDirectMinB on; #9 staged from
    kStagedMinB on and to K = 606."""
    lo = LKJ_C["kDirectMinB"]
    assert LKJ_C["kMaxUnrolledDirect"] == 8 and lo == 32768
    assert [lkj_design(K, 64) for K in (2, 5, 8, 9, 16, 17, 42, 43, 400)] == [
        "unrolled"] * 3 + ["staged"] * 4 + ["ahead"] * 2
    assert [lkj_design(16, B) for B in (1, lo - 1, lo, 131072)] == ["staged"] * 2 + ["ahead"] * 2
    assert lkj_staged_shape(16, 131072) == (64, 256)
    assert lkj_staged_shape(16, 64) == (1, 128)
    assert lkj_staged_shape(9, 1000) == (4, 256)
    lo9 = FWD_C["kStagedMinB"]
    assert [fwd_design(16, B) for B in (64, lo9 - 1, lo9, 131072)] == ["direct"] * 2 + ["staged"] * 2
    assert [fwd_design(K, 131072) for K in (2, 606, 607)] == ["staged", "staged", "direct"]
    assert fwd_staged_shape(16) == 128


def test_prefetch_rows_steps_as_divisions():
    """prefetch_rows' stepping of (e, q) by the block's threads is the
    division of the flattened index, at every P against several blocks."""
    for P, n, nt in ((1, 7, 32), (10, 256, 256), (15, 128, 128), (120, 64, 256), (136, 3, 32)):
        pairs = prefetch_rows_pairs(n, P, nt)
        by_thread = {}
        for tid in range(min(nt, n * P)):
            by_thread[tid] = [divmod(i, P) for i in range(tid, n * P, nt)]
        assert pairs == [p for tid in sorted(by_thread) for p in by_thread[tid]]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.7, 1e10])
@pytest.mark.parametrize("chol", [False, True])
@pytest.mark.parametrize("K", [2, 3, 5, 8])
def test_lkj_logdet_against_the_jax_kernel(rng, K, chol, scale):
    """K <= 8: the float32 emulation against lkj_logdet_pallas in interpret
    mode in float64 on the same (float32) inputs, at RTOL_SUM of the
    magnitude plus `cancel_floor`; the port's float64 plain version against
    it at VAL_TOL."""
    P = K * (K - 1) // 2
    y = _inputs(rng, 37, P, scale).astype(F32).astype(np.float64)
    lj, ldw = lkj_emulated(y, K, chol)
    rlj, rldw = _JAX_LKJ[chol](jnp.asarray(y), K)
    close(lj, rlj, RTOL_SUM, floor=cancel_floor(P * K))
    close(ldw, rldw, RTOL_SUM, floor=cancel_floor(K))
    plj, pldw = kl.lkj_logdet_plain(torch.as_tensor(y), K, chol)
    np.testing.assert_allclose(plj.numpy(), np.asarray(rlj), **VAL_TOL)
    np.testing.assert_allclose(pldw.numpy(), np.asarray(rldw), **VAL_TOL)


@pytest.mark.parametrize("scale", [0.5, 1e10])
@pytest.mark.parametrize("chol", [False, True])
def test_lkj_logdet_k16_against_the_jax_jnp_path(rng, chol, scale):
    """K = 16, the bench LKJ: the float32 emulation against the JAX jnp path
    in float64 as above; the plain version at VAL_TOL."""
    y = _inputs(rng, 64, 120, scale).astype(F32).astype(np.float64)
    jfn = jcorr._chol_logdet_jnp if chol else jcorr._vec_corr_logdet_jnp
    rlj, rldw = jax.jit(jfn)(jnp.asarray(y))
    lj, ldw = lkj_emulated(y, 16, chol)
    close(lj, rlj, RTOL_SUM, floor=cancel_floor(120 * 16))
    close(ldw, rldw, RTOL_SUM, floor=cancel_floor(16))
    plj, pldw = kl.lkj_logdet_plain(torch.as_tensor(y), 16, chol)
    np.testing.assert_allclose(plj.numpy(), np.asarray(rlj), **VAL_TOL)
    np.testing.assert_allclose(pldw.numpy(), np.asarray(rldw), **VAL_TOL)


def fwd_checks(x, ry, rld):
    """The float32 emulation against float32 references (the eps of the
    algebra is the dtype's, so a float64 reference is another function):
    y at ATOL_LOGIT of its conditioning (chip_smoke.fwd_y_scale), ld at
    RTOL_SUM of the magnitude plus an ulp of each of its K terms."""
    y, ld = forward_emulated(x)
    K = x.shape[1]
    close(y, ry, ATOL_LOGIT, chip_smoke.fwd_y_scale(torch.as_tensor(x)).numpy())
    close(ld, rld, RTOL_SUM, floor=4.0 * K * float(EPS32))


@pytest.mark.parametrize("K,faces", [(2, False), (3, False), (5, False), (8, False),
                                     (3, True), (5, True), (8, True)])
def test_forward_against_the_jax_kernel(rng, K, faces):
    """K <= 8, interior points and points on the simplex's faces (where
    1e10 states put the inverse): the float32 emulation against
    simplex_forward_logdet_pallas in interpret mode in float32; the plain
    version against it in float64 at VAL_TOL."""
    x = _simplex_points(rng, 41, K, 1e10 if faces else 1.0)
    ry, rld = _JAX_FWD(jnp.asarray(x, jnp.float32))
    fwd_checks(x, ry, rld)
    py, pld = ks.simplex_forward_logdet_plain(torch.as_tensor(x))
    jy, jld = _JAX_FWD(jnp.asarray(x))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **VAL_TOL)
    np.testing.assert_allclose(pld.numpy(), np.asarray(jld), **VAL_TOL)


@pytest.mark.parametrize("faces", [False, True])
def test_forward_k16_against_the_jax_jnp_path(rng, faces):
    """K = 16, the bench Dirichlet: the float32 emulation against the JAX
    jnp path in float32; the plain version against it in float64 at
    VAL_TOL."""
    x = _simplex_points(rng, 64, 16, 1e10 if faces else 1.0)
    jfn = jax.jit(jsimplex._simplex_forward_logdet_jnp)
    fwd_checks(x, *jfn(jnp.asarray(x, jnp.float32)))
    ry, rld = jfn(jnp.asarray(x))
    py, pld = ks.simplex_forward_logdet_plain(torch.as_tensor(x))
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **VAL_TOL)
    np.testing.assert_allclose(pld.numpy(), np.asarray(rld), **VAL_TOL)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lay", LAYOUTS)
def test_wrappers_hand_the_kernels_strides_and_count_launches(monkeypatch, lay):
    """Off the CPU each wrapper launches once under its key, with y's two
    strides as they are (the layouts read in place); a CPU tensor runs the
    plain version and launches nothing."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda fn, name, dev, *args: calls.append(
        (fn, name, args)))
    B = 64
    state = {"batch-major slice": torch.zeros((B, 151), device="meta")[:, 31:],
             "contiguous": torch.zeros((B, 120), device="meta"),
             "swapped": torch.zeros((151, B), device="meta")[31:].T}[lay]
    kl.lkj_logdet(state, 16)
    kl.lkj_logdet(state[:, :10], 5, chol=True)
    ks.simplex_forward_logdet(state[:, :16])
    (f5, n5, a5), (f5c, n5c, a5c), (f9, n9, a9) = calls
    assert (f5, n5, f5c, n5c) == ("tbt_lkj_logdet", "lkj_logdet", "tbt_lkj_logdet",
                                  "lkj_logdet_chol")
    assert a5[1:3] == state.stride() and a5[-3:] == (16, 0, B) and a5c[-3:] == (5, 1, B)
    assert (f9, n9) == ("tbt_simplex_forward_logdet", "simplex_forward_logdet")
    assert a9[1:3] == state.stride() and a9[-2:] == (16, B)
    before = dict(kernels.LAUNCHES)
    y = torch.zeros((3, 120), dtype=torch.float64)
    for got, ref in zip(kl.lkj_logdet(y, 16), kl.lkj_logdet_plain(y, 16)):
        assert torch.equal(got, ref)
    assert kernels.LAUNCHES == before
