"""Build and load the hand-written CUDA kernels.

The sources in `csrc/` are compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). The library goes under `build/torch_ext/` at
the root of the checkout, named by a hash of the sources and flags, and is
built at first use. A failed build raises.
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
_SOURCES = ("fused_slab.cu", "slab_api.cpp")
_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
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
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"libtbt_slab_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_FLAGS, "-o", tmp, *(str(_CSRC / s) for s in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
    return so


def load():
    """The loaded library, built at first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tbt_slab_value.argtypes = [p, p, p, i, ll, p]
        lib.tbt_slab_value_and_grad.argtypes = [p, p, p, p, i, ll, p]
        lib.tbt_slab_vjp.argtypes = [p, p, p, p, i, ll, p]
        for fn in (lib.tbt_slab_value, lib.tbt_slab_value_and_grad, lib.tbt_slab_vjp):
            fn.restype = i
        lib.tbt_error_string.argtypes = [i]
        lib.tbt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
