"""The per-opcode probe of the traced entries' interpreter on the card: the
wrapper of the CUDA kernel `csrc/prim_probe.cu`, its plain version, the
grids it runs on and the checks it makes (counterpart of the TPU probe
`tools/prim_lowering_probe.py`, whose PRIM_LOWERING.json pins the JAX
package's admission set).

For each opcode of `fused_decomp._SAFE_PRIMS` it builds a one-instruction
tape (`one_op_tape`), launches it through the interpreter's own device
function at B = 131072 over a grid that covers the op's domain and its
edge points (`inputs`: +-0, ties, bounds, +-1, 20 and its neighbour (the
softplus threshold), +-88 (exp's overflow), +-1e10, +-1e20, +-inf), once a
differentiable operand with a unit tangent on it, and holds the value and
the tangent against the plain version (the same tape in torch ops on the
card, float32), against the torch op and torch.autograd in float64 (the
same pattern of NaN and +-inf as float64 rounded to float32, and within
`TOL` of |ref| + 1 where finite). Any opcode that fails makes the probe
fail: the port's admission set is what the card computes right.

    python -m tpu_bijectors_torch.kernels.prim_probe

prints the card's name and power limit and one JSON line an opcode (its
errors, launches, time by CUDA events, bytes and byte bound); it exits 1
if an opcode fails and writes no file. It raises where there is no card.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..vectorize import fused_decomp as fd
from ..vectorize import fused_traced as ft

BATCH = 131072
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet, at 700 W
# float32 against float64: a few ulp of each op and of its tangent rule's
# two or three operations, on |ref| + 1 (absolute near 0, relative above)
TOL = 1e-5
EDGES = (0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 1e-3, -1e-3, 20.0, 20.5, -20.0, 88.0,
         -88.0, 1e10, -1e10, 1e20, -1e20, math.inf, -math.inf)
# the operands that carry a tangent, by opcode (none: a comparison, a
# logical op, logsumexp's pieces)
_DIFF = {"where": (1, 2), "clamp": (0,)}


def diff_operands(name):
    op = fd.OPS[name]
    if not op.tangent:
        return ()
    return _DIFF.get(name, tuple(range(op.arity)))


def one_op_tape(name, j=None):
    """The one-instruction tape of opcode `name`: operands in slots 0, 1,
    2, result in slot 3; operand j (None: none) carries a tangent."""
    op = fd.OPS[name]
    bits = 0
    if j is not None:
        bits = (ft.TAN_A, ft.TAN_B, ft.TAN_C)[j] | ft.TAN_OUT
    words = (1, 4, 3, 3, 0, int(j is not None), op.code | bits, 3, 0, 1, 2)
    return ft.Tape(words, (0.0,), 3, False, 1, 1)


def inputs(name, device, B=BATCH, dtype=torch.float32, seed=14):
    """(x, y, z) (B,) each: every pair of EDGES, ties, then random values
    of every scale (normal, +-e^U(-30, 30), integers); the condition of
    `where` and the operands of the logical ops mostly 0 or 1."""
    rng = np.random.default_rng(seed)
    e = np.asarray(EDGES)
    ex, ey = np.meshgrid(e, e, indexing="ij")
    head = len(e) ** 2
    n = B - head
    scale = np.exp(rng.uniform(-30, 30, n)) * np.sign(rng.standard_normal(n))
    pick = rng.integers(0, 3, n)
    x = np.where(pick == 0, 3 * rng.standard_normal(n),
                 np.where(pick == 1, scale, rng.integers(-4, 5, n)))
    y = np.where(rng.integers(0, 2, n) == 0, 3 * rng.standard_normal(n), x)  # ties
    z = 3 * rng.standard_normal(n) + 2.0
    x = np.concatenate([ex.ravel(), x])
    y = np.concatenate([ey.ravel(), y])
    z = np.concatenate([np.resize(e[::-1], head), z])
    if name in ("where", "and", "or", "not", "b2f"):
        x = np.where(rng.integers(0, 3, B) == 0, x, rng.integers(0, 2, B))
        if name in ("and", "or"):
            y = np.where(rng.integers(0, 3, B) == 0, y, rng.integers(0, 2, B))
    if name == "pow":
        # a negative base has a power at integer exponents only, and
        # float32 rounds y - 1 to an integer where float64 does not (0 <
        # |y| < 2^-20) or loses its parity (|y| >= 2^24): the derivative's
        # NaN and sign differ by the rounding alone. Such exponents go to
        # bases of sign bit 0
        ay = np.abs(y)
        y = np.where(np.signbit(x) & ((ay >= 2.0**24) | ((ay < 2.0**-20) & (ay > 0))), 3.0, y)
    if name == "clamp":  # bounds lo <= hi, some equal
        lo = np.minimum(y, z)
        z = np.where(rng.integers(0, 8, B) == 0, lo, np.maximum(y, z))
        y = lo
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return t(x), t(y), t(z)


def prim_probe_plain(name, x, y, z, j=None):
    """The plain version: (value, tangent) of the one-op tape in torch
    ops, unit tangent on operand j (zero tangent where j is None)."""
    tape = one_op_tape(name, j)
    consts = torch.zeros(1, dtype=x.dtype, device=x.device)
    tans = None if j is None else [torch.full_like(x, float(i == j)) for i in range(3)]
    r, t = ft.run_tape_plain(tape, consts, [x, y, z], tans)
    r = torch.broadcast_to(r, x.shape)
    return r, (torch.zeros_like(x) if t is None else torch.broadcast_to(t, x.shape))


@lru_cache(maxsize=None)
def _program(name, j, device):
    """The one-op tape and its (unused) constant on `device`, made once."""
    prog = torch.tensor(one_op_tape(name, j).words, dtype=torch.int32, device=device)
    return prog, torch.zeros(1, dtype=torch.float32, device=device)


def prim_probe(name, x, y, z, j=None):
    """(value, tangent) of opcode `name` on the card's interpreter, unit
    tangent on operand j; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return prim_probe_plain(name, x, y, z, j)
    for a in (x, y, z):
        if a.dtype != torch.float32 or not a.is_contiguous() or a.shape != x.shape \
                or a.device != x.device:
            raise ValueError("prim_probe takes three contiguous float32 (B,) tensors on "
                             "one device")
    prog, consts = _program(name, j, x.device)
    r, t = torch.empty_like(x), torch.empty_like(x)
    s = [float(i == j) for i in range(3)]
    kernels.launch("tbt_prim_probe", "prim_probe", x.device, prog.data_ptr(), consts.data_ptr(),
                   x.data_ptr(), y.data_ptr(), z.data_ptr(), *s, r.data_ptr(), t.data_ptr(),
                   x.numel())
    return r, t


def reference(name, x, y, z, j=None):
    """The torch op and its torch.autograd derivative along operand j, in
    float64 (value, derivative or None)."""
    xs = [a.double().detach().requires_grad_(i == j) for i, a in enumerate((x, y, z))]
    r = fd.OPS[name].value(*xs)
    if j is None:
        return r.detach(), None
    (g,) = torch.autograd.grad(r.sum(), xs[j], allow_unused=True)
    return r.detach(), (torch.zeros_like(r) if g is None else g)


def compare(got, ref):
    """(max error on |ref| + 1 where both are finite, whether got has the
    NaN / +inf / -inf pattern of ref rounded to got's dtype)."""
    r32 = ref.to(got.dtype)
    same = (torch.equal(torch.isnan(got), torch.isnan(r32))
            and torch.equal(torch.isposinf(got), torch.isposinf(r32))
            and torch.equal(torch.isneginf(got), torch.isneginf(r32)))
    fin = torch.isfinite(got) & torch.isfinite(ref)
    err = ((got.double() - ref.double()).abs() / (ref.double().abs() + 1.0))[fin]
    return (float(err.max()) if err.numel() else 0.0), same


def check_op(name, x, y, z):
    """Every launch of opcode `name` (the value, then one a differentiable
    operand) against the plain version and float64: a dict of its errors
    and `ok`."""
    row = {"op": name, "code": fd.OPS[name].code, "jax": list(fd.JAX_NAMES[name]),
           "err_value": 0.0, "err_value_plain": 0.0, "err_tangent": 0.0,
           "err_tangent_plain": 0.0, "pattern": True}
    for j in (None, *diff_operands(name)):
        r, t = prim_probe(name, x, y, z, j)
        pr, pt = prim_probe_plain(name, x, y, z, j)
        rr, rt = reference(name, x, y, z, j)
        checks = [("err_value", r, rr), ("err_value_plain", r, pr)]
        if j is not None:
            checks += [("err_tangent", t, rt), ("err_tangent_plain", t, pt)]
        for key, got, ref in checks:
            err, same = compare(got, ref)
            row[key] = max(row[key], err)
            row["pattern"] = row["pattern"] and same
    row["ok"] = row["pattern"] and max(row[k] for k in (
        "err_value", "err_value_plain", "err_tangent", "err_tangent_plain")) <= TOL
    return row


def time_us(fn, reps=20, inner=10):
    """Median µs of one call by CUDA events, the card kept busy (it spins
    while the host enqueues the calls, so the window holds card time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(1e3 * a.elapsed_time(b) / inner)
    return statistics.median(out)


def run(device=None):
    """Check and time every opcode of the admission set at B = 131072 on
    the card; returns one row an opcode (`ok` False where it fails)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("the probe measures the card; no CUDA device given")
    rows = []
    nbytes = 5 * 4 * BATCH  # x, y, z read, r and t written
    for name in sorted(fd._SAFE_PRIMS, key=lambda n: fd.OPS[n].code):
        x, y, z = inputs(name, dev)
        before = kernels.LAUNCHES["prim_probe"]
        row = check_op(name, x, y, z)
        row["launches"] = kernels.LAUNCHES["prim_probe"] - before
        j = (diff_operands(name) or (None,))[0]
        row["us"] = time_us(lambda: prim_probe(name, x, y, z, j))
        row["bytes"] = nbytes
        row["bound_us"] = nbytes / PEAK_BYTES_PER_S * 1e6
        rows.append(row)
    return rows


def main():
    if not torch.cuda.is_available():
        print("prim_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    rows = run()
    for row in rows:
        print(json.dumps(row), flush=True)
    bad = [r["op"] for r in rows if not r["ok"]]
    if bad:
        print(f"prim_probe: opcodes that fail on the card: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
