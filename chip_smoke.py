"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the slab kernels from `tpu_bijectors_torch/kernels/csrc/`, then runs
the bench model (8 Normal, 8 LogNormal, Dirichlet(16), LKJ(16): linked
dim 151) at B = 131072 in float32 through the entry points a user calls:
`Model.batched_logdensity_t_fn()` (the value kernel), its
`value_and_grad_fn` (the one-pass value-and-gradient kernel) and
`torch.autograd.grad` through `linked_logdensity_t` (the vector-Jacobian
kernel). Each kernel is held against its plain PyTorch version on the same
inputs; the log-density also against the composed per-leaf path and the
plain path in float64. Every kernel and its plain version is timed with
CUDA events.

Prints the card's name and power limit, one JSON line per kernel, a
`{"kernels": [...]}` line, and as the last line
`{"ok": true, "device": {...}}`. Exits non-zero, with no result, when CUDA
is absent or any check fails.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 131072
SEED = 0
# float32 reordering of a 151-term sum: the kernel adds the rows one by one
# in a register, the plain version reduces them in another order. The lp
# tolerances are relative to the magnitude of the terms the sum carries
# (|sum of slab terms| + |c0 row sum|); the gradient is one row per element.
RTOL_LP = 2e-5
RTOL_G = 1e-5
RTOL_COMPOSED = 1e-4  # another algebra (cumsums, logcosh of packed slots)
# published peaks of the H100 SXM (NVIDIA data sheet), at a 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations per element of one row, per term group and kernel mode (each
# arithmetic operation, comparison, select and transcendental counts one, so
# the operation bound is a floor: an accurate expf or log1pf takes several
# instructions), plus 2 per element for the ownership select and the
# centring subtract
OPS = {
    "value": {"lin": 3, "quad": 4, "absv": 6, "sp": 8, "exp": 7, "l1p": 7},
    "value_and_grad": {"lin": 4, "quad": 7, "absv": 7, "sp": 15, "exp": 10, "l1p": 14},
    "vjp": {"lin": 2, "quad": 4, "absv": 5, "sp": 12, "exp": 6, "l1p": 9},
}
REPLACES = {
    "slab_value": "tpu_bijectors/vectorize/fused_kernel.py:226",
    "slab_value_and_grad": "tpu_bijectors/vectorize/fused_kernel.py:383",
    "slab_vjp": "tpu_bijectors/vectorize/fused_kernel.py:321",
}

failures = []


def check(name, got, ref, rtol, scale=None):
    """Record got vs ref: |got - ref| <= rtol * scale elementwise (scale
    defaults to |ref| + 1e-3 max|ref|). Returns the max absolute error."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        failures.append(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        return float("inf")
    if scale is None:
        scale = ref.abs() + 1e-3 * ref.abs().max()
    err = (got - ref).abs()
    ratio = float((err / scale).max())
    max_abs = float(err.max())
    ok = bool(torch.isfinite(got).all()) and ratio <= rtol
    print(f"{name}: max_abs_err {max_abs:.3e} max_rel_err {ratio:.3e} rtol {rtol:g}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{name}: rel err {ratio:.3e} > {rtol:g}")
    return max_abs


def expect(name, cond):
    print(f"{name}: {'ok' if cond else 'FAIL'}", flush=True)
    if not cond:
        failures.append(name)


def bench_model(dists, device, dtype):
    """bench.py's model, same parameters."""
    kw = dict(device=device, dtype=dtype)
    return dists.NamedProduct.of(
        mu=dists.IIDProduct(dists.Normal(0.0, 2.0, **kw), 8),
        sigma=dists.IIDProduct(dists.LogNormal(0.0, 0.5, **kw), 8),
        w=dists.Dirichlet(np.ones(16), **kw),
        corr=dists.LKJ(16, 2.0, **kw),
    )


def time_ms(fn, reps=25, inner=10, warmup=5, device_only=True):
    """Median over `reps` CUDA-event timings of `inner` back-to-back calls.
    With `device_only` the card spins (about 2.5 ms) while the host
    enqueues the calls, so the window holds card time only; without it the
    host's dispatch time counts too (what a caller of an entry point sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.kernels import build
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    so = build.build()
    build.load()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    model = tbt.Model(bench_model(dists, dev, torch.float32), device=dev)
    u = model.unconstrainer()
    dim = model.dim()
    expect(f"dim {dim} == 151", dim == 151)
    rng = np.random.default_rng(SEED)
    v = 0.5 * rng.standard_normal((BATCH, dim))
    vT = torch.as_tensor(np.ascontiguousarray(v.T), dtype=torch.float32, device=dev)
    f = model.batched_logdensity_t_fn()

    # --- the main path: value, value-and-gradient, autograd ------------------
    kernels.reset_launch_counts()
    for _ in range(3):
        lp = f(vT)
    for _ in range(3):
        lp_vg, g_vg = f.value_and_grad_fn(vT)
    vr = vT.detach().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(u.linked_logdensity_t(vr).sum(), vr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the main path: {launches}", flush=True)
    for k, n in launches.items():
        expect(f"{k} launched on the main path", n > 0)
    expect("lp shape (B,)", lp.shape == (BATCH,) and lp_vg.shape == (BATCH,))
    expect("g shape (dim, B)", g_vg.shape == (dim, BATCH) and g_ag.shape == (dim, BATCH))

    # --- value ---------------------------------------------------------------
    cf, c0sum = fk._prep(u, vT)
    val_plain = fb.slab_value_plain(vT, cf)
    scale = val_plain.abs() + c0sum.abs()
    err = {}
    err["slab_value"] = check(
        "value kernel vs plain", fk.slab_value(vT, cf), val_plain, RTOL_LP, scale
    )
    check("linked_logdensity_t vs plain fused", lp, val_plain + c0sum, RTOL_LP, scale)
    composed = u._linked_logdensity_t_children(vT)
    check("linked_logdensity_t vs composed", lp, composed, RTOL_COMPOSED, scale)
    model64 = tbt.Model(bench_model(dists, dev, torch.float64), device=dev)
    vT64 = vT.double()
    cf64, c0sum64 = fk._prep(model64.unconstrainer(), vT64)
    lp64 = fb.slab_value_plain(vT64, cf64) + c0sum64
    check("linked_logdensity_t vs plain float64", lp, lp64, RTOL_LP, scale)
    del composed, vT64, lp64

    # --- value and gradient --------------------------------------------------
    lp_p, g_p = fb.slab_value_and_grad_plain(vT, cf)
    lp_k, g_k = fk.slab_value_and_grad(vT, cf)
    err["slab_value_and_grad"] = max(
        check("value-and-grad kernel lp vs plain", lp_k, lp_p, RTOL_LP, scale),
        check("value-and-grad kernel g vs plain", g_k, g_p, RTOL_G),
    )
    check("value_and_grad_fn lp vs plain", lp_vg, lp_p + c0sum, RTOL_LP, scale)
    check("value_and_grad_fn g vs plain", g_vg, g_p, RTOL_G)

    # --- autograd ------------------------------------------------------------
    ones = torch.ones(BATCH, device=dev)
    g_vjp_plain = fb.slab_vjp_plain(vT, cf, ones)
    err["slab_vjp"] = check(
        "vjp kernel vs plain", fk.slab_vjp(vT, cf, ones), g_vjp_plain, RTOL_G
    )
    check("autograd g vs value_and_grad_fn g", g_ag, g_vg, RTOL_G)
    check("autograd g vs plain partials", g_ag, g_p, RTOL_G)
    del lp_p, g_p, lp_k, g_k, g_vjp_plain, g_ag, g_vg

    # --- extreme states ------------------------------------------------------
    vx = 1e10 * rng.standard_normal((4096, dim))
    vx[::7] = np.sign(vx[::7]) * 1e10
    vxT = torch.as_tensor(np.ascontiguousarray(vx.T), dtype=torch.float32, device=dev)
    lpx = f(vxT)
    lpx_vg, gx = f.value_and_grad_fn(vxT)
    expect("lp finite at 1e10 states", bool(torch.isfinite(lpx).all()))
    expect("value_and_grad lp finite at 1e10", bool(torch.isfinite(lpx_vg).all()))
    expect("g finite at 1e10 states", bool(torch.isfinite(gx).all()))
    cfx, c0x = fk._prep(u, vxT)
    lpx_p, gx_p = fb.slab_value_and_grad_plain(vxT, cfx)
    check("1e10: lp vs plain", lpx, lpx_p + c0x, RTOL_LP, lpx_p.abs() + c0x.abs())
    check("1e10: Dirichlet and LKJ rows of g vs plain", gx[16:], gx_p[16:], RTOL_G)
    check("1e10: Normal and LogNormal rows of g vs plain", gx[:16], gx_p[:16], RTOL_G)

    # --- timing ----------------------------------------------------------------
    groups_per_row = [fb._groups_and_used(cf[r : r + 1])[0] for r in range(dim)]
    nbytes = {
        "slab_value": vT.numel() * 4 + BATCH * 4 + cf.numel() * 4,
        "slab_value_and_grad": 2 * vT.numel() * 4 + BATCH * 4 + cf.numel() * 4,
        "slab_vjp": 2 * vT.numel() * 4 + BATCH * 4 + cf.numel() * 4,
    }
    mode = {"slab_value": "value", "slab_value_and_grad": "value_and_grad", "slab_vjp": "vjp"}
    runs = {
        "slab_value": (lambda: fk.slab_value(vT, cf), lambda: fb.slab_value_plain(vT, cf)),
        "slab_value_and_grad": (
            lambda: fk.slab_value_and_grad(vT, cf),
            lambda: fb.slab_value_and_grad_plain(vT, cf),
        ),
        "slab_vjp": (
            lambda: fk.slab_vjp(vT, cf, ones),
            lambda: fb.slab_vjp_plain(vT, cf, ones),
        ),
    }
    rows = []
    for k, (kern, plain) in runs.items():
        ops = BATCH * sum(2 + sum(OPS[mode[k]][g] for g in gs) for gs in groups_per_row)
        t_bytes = nbytes[k] / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        row = {
            "name": k,
            "route": "cuda",
            "source": "tpu_bijectors_torch/kernels/csrc/fused_slab.cu",
            "replaces": REPLACES[k],
            "launches": launches[k],
            "max_abs_err": err[k],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        # the counts bound_ms is computed from (not measured)
        print(json.dumps({"bound_inputs": {"name": k, "bytes": nbytes[k], "ops": ops}}),
              flush=True)

    # the entry points as a caller sees them: host dispatch included, at the
    # full batch and at a sampler's batch of 64 chains
    v64 = vT[:, :64].contiguous()
    e2e = {
        "value_ms_B131072": time_ms(lambda: f(vT), device_only=False),
        "value_and_grad_ms_B131072": time_ms(
            lambda: f.value_and_grad_fn(vT), device_only=False
        ),
        "value_ms_B64": time_ms(lambda: f(v64), device_only=False),
        "value_and_grad_ms_B64": time_ms(
            lambda: f.value_and_grad_fn(v64), device_only=False
        ),
    }
    print(json.dumps({"end_to_end": e2e}), flush=True)

    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
