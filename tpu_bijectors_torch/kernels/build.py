"""Build and load the hand-written CUDA kernels.

The sources in `csrc/` are compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Every source is compiled by its own `nvcc`
process, all started together, and the objects are linked into one
library (the headers `csrc/*.cuh` are hashed with the sources). The
library goes under `build/torch_ext/` at the root of the
checkout, named by a hash of the sources and flags, and is built at first
use. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (
    "fused_slab.cu",
    "slab_api.cpp",
    "simplex_inv.cu",
    "simplex_fwd.cu",
    "lkj_inv.cu",
    "lkj_logdet.cu",
    "pd_inverse.cu",
    "pd_logdensity.cu",
    "pd_trace_grad.cu",
    "transcend_probe.cu",
    "prim_probe.cu",
)
_HEADERS = ("link_tiles.cuh", "pd_common.cuh", "pd_tiles.cuh", "traced_tape.cuh")
_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_COMPILE = ("-c", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"

_lib = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS + _COMPILE).encode())
    for name in _SOURCES + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"libtbt_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise naming the first that failed.
    Returns each command's standard error."""
    cmds = list(cmds)
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for c, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{err}")
    return [err for _, err in outs]


def build(report: dict | None = None) -> Path:
    """Compile the library if it is not built yet; returns its path. With
    `report` (a dict), each source compiled here is compiled with
    `-Xptxas=-v` and its register, shared-memory and spill lines land in
    report[source]; a library already built leaves `report` empty."""
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in _SOURCES]
        verbose = ("-Xptxas=-v",) if report is not None else ()
        errs = _run_all(
            [nvcc, *_FLAGS, *_COMPILE, *verbose, "-o", o, str(_CSRC / s)]
            for s, o in zip(_SOURCES, objs)
        )
        if report is not None:
            report.update({s: [ln.strip() for ln in e.splitlines() if "ptxas" in ln]
                           for s, e in zip(_SOURCES, errs)})
        out = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *_FLAGS, "-shared", "-o", out, *objs]])
        os.replace(out, so)  # atomic: a concurrent process sees all or nothing
    return so


def load():
    """The loaded library, built at first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        sigs = {
            # vT, run table, runs, the first block's row and rows, packed
            # coefficients, their count, entry table, entries, loop
            # parameters, their count, largest PD K, tapes, lp, B, stream
            "tbt_slab_value": [p, p, i, i, i, p, i, p, i, p, i, i, p, p, ll, p],
            # vT, cf, entry table, entries, loop parameters, their count,
            # largest PD K, the traced entries' tapes, then ct or dvT and
            # the outputs, dim, B, stream
            "tbt_slab_value_and_grad": [p, p, p, i, p, i, i, p, p, p, i, ll, p],
            "tbt_slab_vjp": [p, p, p, i, p, i, i, p, p, p, i, ll, p],
            "tbt_slab_jvp": [p, p, p, i, p, i, i, p, p, p, i, ll, p],
            # vT, cf, item table, items, loop parameters, tapes, scratch
            # floats a warp, loops, lp, g, dim, B, stream
            "tbt_slab_value_and_grad_items": [p, p, p, i, p, p, i, i, p, p, i, ll, p],
            # stream
            "tbt_empty": [p],
            # y, y strides (batch, coordinate), log(K-1-k) table, am1, x, ld,
            # wlog, K-1, small design, B, stream
            "tbt_simplex_inverse_logdet": [p, ll, ll, p, p, p, p, p, i, i, ll, p],
            # y, y strides, log(K-1-k) table, x, K-1, small design, B, stream
            "tbt_simplex_inverse": [p, ll, ll, p, p, i, i, ll, p],
            # x, x strides (batch, coordinate), log(K-1-k) table, y, ld, K,
            # B, stream
            "tbt_simplex_forward_logdet": [p, ll, ll, p, p, p, i, ll, p],
            # y, y strides (batch, slot), X, logJ, log diag W, W, K, B, stream
            "tbt_lkj_inverse": [p, ll, ll, p, p, p, p, i, ll, p],
            # y, y strides (batch, slot), logJ, log diag W, K, chol, B, stream
            "tbt_lkj_logdet": [p, ll, ll, p, p, i, i, ll, p],
            # y, y strides (batch, slot), X, logJ, L, K, B, stream
            "tbt_pd_inverse": [p, ll, ll, p, p, p, i, ll, p],
            # y, y strides, C, logJ, sum y_rr, trace, K, solve, B, stream
            "tbt_pd_logdensity": [p, ll, ll, p, p, p, p, i, i, ll, p],
            # y, y strides, C, g, g strides (batch, slot), K, solve, B, stream
            "tbt_pd_trace_grad": [p, ll, ll, p, p, ll, ll, i, i, ll, p],
            # variant, vT, c, lp, g, the 8 polynomial coefficients (host
            # floats), dim, B, stream
            "tbt_transcend_probe": [i, p, p, p, p, ctypes.POINTER(ctypes.c_float), i, ll, p],
            # one-op tape, its constants, x, y, z, the operands' tangents
            # (host floats), r, t, B, stream
            "tbt_prim_probe": [p, p, p, p, p, f, f, f, p, p, ll, p],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        lib.tbt_error_string.argtypes = [i]
        lib.tbt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
