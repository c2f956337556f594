"""A probe of the slab engine's per-element math on the card: the wrapper of
the CUDA kernel `csrc/transcend_probe.cu`, the plain PyTorch version of
each of its variants, and a driver that times them (counterpart of the
TPU probe `tools/transcend_probe.py`).

Each variant reads the state vT (dim, B), scales it by the column's
coefficient, X = V * c[0, col % 2048], and returns lp (B,) = the sum over
rows of X^2 plus its own term (see `VARIANTS`); floor_g also returns its
gradient-shaped output g = X + 1 (dim, B). The variants split the slab
rows' work (fused_base.py) into pieces: the memory floor, ALU operations,
exp, log, softplus, sigmoid and selects. Their times against the floor's,
and the slab kernel's against the variant of the same math, tell whether
the slab value kernel is held by its per-element math or by its own
structure (the table reads, the row flags).

    python -m tpu_bijectors_torch.kernels.probe [variant ...]

runs on the card at dim 151, B = 131072 (the bench model's shape) and
prints, per variant, its time by CUDA events with the card kept busy
while the host enqueues, its bytes, the byte bound at 3.35 TB/s and its
share, and its excess over floor. It writes no file. It raises where
there is no card.
"""

from __future__ import annotations

import json
import statistics
import sys
from functools import lru_cache

import numpy as np
import torch

from .. import kernels

VARIANTS = (
    "floor", "floor_g", "alu8", "exp1", "log1", "sp", "sp_poly", "sig", "spsig",
    "spsig_sh", "spsig_sh2", "sel4", "band16",
)
C_WIDTH = 2048  # the TPU probe's block width: each block read c[0, :2048]
BAND = 16  # band16's rows
DIM, BATCH = 151, 131072
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet, at 700 W


@lru_cache(maxsize=None)
def poly_coeffs():
    """The degree-7 least-squares polynomial for log1p(z) on [0, 1],
    highest degree first, as the TPU probe fits it (timing-representative,
    not exact)."""
    z = np.linspace(0, 1, 4001)
    return tuple(float(c) for c in np.polyfit(z, np.log1p(z), 7))


def _poly_log1p(z):
    p = poly_coeffs()
    acc = torch.full_like(z, p[0])
    for c in p[1:]:
        acc = acc * z + c
    return acc


def _alu8(X):
    U = torch.abs(X)
    t = torch.where(X >= 0, U * 1.25, U * 0.75)
    t = t * t + U
    t = torch.where(t > 1.0, t - 1.0, t)
    return t * 0.5 + U


def _extra(variant, X):
    """The variant's per-element term of every row of X (dim, B)."""
    if variant == "alu8":
        return _alu8(X)
    if variant == "band16":
        return _alu8(X[:BAND])
    if variant == "exp1":
        return torch.exp(-torch.abs(X))
    if variant == "log1":
        return torch.log(1.5 + torch.abs(X))
    a = -2.0 * torch.abs(X)
    if variant == "sp":
        return torch.log1p(torch.exp(a))
    if variant == "sp_poly":
        return _poly_log1p(torch.exp(a))
    if variant == "sig":
        return torch.sigmoid(a)
    if variant == "spsig":
        return torch.log1p(torch.exp(a)) + torch.sigmoid(a)
    if variant in ("spsig_sh", "spsig_sh2"):
        e = torch.exp(a)
        log1p = _poly_log1p(e) if variant == "spsig_sh" else torch.log1p(e)
        return log1p + e / (1.0 + e)
    if variant == "sel4":
        t = torch.where(X > 0.0, X, torch.zeros_like(X))
        t = torch.where(X > 1.0, t, X * 0.5)
        t = torch.where(X < -1.0, t, X * 0.25)
        return torch.where(X != 0.0, t, torch.zeros_like(X))
    raise KeyError(variant)


def _scaled(vT, c):
    """X = vT * c[0, col % 2048]."""
    return vT * c.reshape(-1)[torch.arange(vT.shape[1], device=vT.device) % C_WIDTH]


def probe_plain(variant, vT, c):
    """The plain version of `probe`: lp (B,), and (lp, g) for floor_g."""
    X = _scaled(vT, c)
    lp = torch.sum(X * X, 0)
    if variant == "floor":
        return lp
    if variant == "floor_g":
        return lp, X + 1.0
    return lp + torch.sum(_extra(variant, X), 0)


def magnitude(variant, vT, c):
    """The sum over rows of |each term| of lp (B,), what its rounding
    scales with."""
    X = _scaled(vT, c)
    mag = torch.sum(X * X, 0)
    if variant in ("floor", "floor_g"):
        return mag
    return mag + torch.sum(torch.abs(_extra(variant, X)), 0)


def probe(variant, vT, c):
    """The variant over vT (dim, B) with the coefficients c (1, 2048): lp
    (B,), and (lp, g) for floor_g. A CUDA tensor launches the kernel (or
    raises); a CPU tensor runs the plain version."""
    if variant not in VARIANTS:
        raise KeyError(f"no probe variant {variant!r}; the variants are {VARIANTS}")
    if vT.device.type == "cpu":
        return probe_plain(variant, vT, c)
    if vT.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("the probe takes float32")
    if vT.ndim != 2 or c.shape != (1, C_WIDTH) or c.device != vT.device:
        raise ValueError(f"need vT (dim, B) and c (1, {C_WIDTH}) on one device; got "
                         f"{tuple(vT.shape)}, {tuple(c.shape)}")
    if not (vT.is_contiguous() and c.is_contiguous()):
        raise ValueError("the probe takes contiguous tensors")
    import ctypes

    dim, B = vT.shape
    lp = torch.empty(B, dtype=vT.dtype, device=vT.device)
    g = torch.empty_like(vT) if variant == "floor_g" else None
    poly = (ctypes.c_float * 8)(*poly_coeffs())
    kernels.launch(
        "tbt_transcend_probe", "transcend_probe", vT.device, VARIANTS.index(variant),
        vT.data_ptr(), c.data_ptr(), lp.data_ptr(), None if g is None else g.data_ptr(),
        poly, dim, B,
    )
    return lp if g is None else (lp, g)


def probe_bytes(variant, dim, B):
    """Bytes the variant must move: vT and c read once, lp (and g) written
    once."""
    n = dim * B * 4 + C_WIDTH * 4 + B * 4
    return n + dim * B * 4 if variant == "floor_g" else n


def time_us(fn, reps=25, inner=10, warmup=5):
    """Median over `reps` CUDA-event timings of `inner` back-to-back calls,
    in microseconds; the card spins (about 2.5 ms) while the host enqueues
    the calls, so the window holds card time only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b) / inner)
    return statistics.median(times)


def inputs(device, dim=DIM, B=BATCH, seed=0):
    """The probe's inputs: vT = N(0, 1) (dim, B) and c = 1 + 1e-3 U(-1, 1)
    (1, 2048), from a torch generator seeded `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vT = torch.randn((dim, B), generator=gen, device=device)
    u = torch.rand((1, C_WIDTH), generator=gen, device=device)
    return vT, 1.0 + 1e-3 * (2.0 * u - 1.0)


def run(variants=VARIANTS, dim=DIM, B=BATCH, device="cuda"):
    """Time each variant on the card; returns one dict a variant (us,
    bytes, byte bound us, its share, excess over floor us where floor was
    timed)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card, and CUDA is not available")
    vT, c = inputs(device, dim, B)
    rows = []
    for v in variants:
        us = time_us(lambda v=v: probe(v, vT, c))
        nbytes = probe_bytes(v, dim, B)
        bound = nbytes / PEAK_BYTES_PER_S * 1e6
        rows.append({"variant": v, "us": us, "bytes": nbytes, "bound_us": bound,
                     "bound_share": bound / us})
    floor = {r["variant"]: r["us"] for r in rows}.get("floor")
    for r in rows:
        r["excess_over_floor_us"] = None if floor is None else r["us"] - floor
    return rows


def main(argv=None):
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    for r in run(names):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
