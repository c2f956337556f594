"""Hand-written CUDA kernels of the port (counterpart of
`tpu_bijectors.kernels`).

Each kernel has a plain PyTorch version of the same function beside its
wrapper. A wrapper runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card; it never gives way to the plain version on
the card. `LAUNCHES` counts, per wrapper, the kernel launches it made.
`enable(False)` sends CPU tensors down the composed per-leaf path instead
of the fused one, and makes `Model.sample(kernel='auto')` take the
batch-major sampler, as the JAX package's switch does; on the card, where
no plain path stands in for a kernel, every launch with the kernels off
raises.

Wrappers: `vectorize/fused_kernel.py` (slab_value, slab_value_and_grad,
slab_vjp, slab_jvp; slab_value_and_grad_small, the value-and-gradient
mode's small-batch design, which the wrapper of slab_value_and_grad
launches at B <= SMALL_B; launch_floor, a kernel that does nothing, timed
as the floor of a launch), `kernels/simplex.py` (simplex_inverse_logdet;
simplex_inverse_logdet_small, its small-batch design, which its wrapper
launches at B <= simplex.SMALL_B; simplex_inverse, simplex_forward_logdet),
`kernels/lkj.py` (lkj_inverse, lkj_logdet, lkj_logdet_chol: its
Cholesky variant), `kernels/pd.py` (pd_inverse, pd_logdensity,
pd_trace_grad), `kernels/probe.py` (transcend_probe, a measurement of
the slab's per-element math, not on any model's path) and
`kernels/prim_probe.py` (prim_probe, the per-opcode check of the traced
entries' interpreter, not on any model's path either). The traced entries
themselves run inside the four slab wrappers (their loop kind `traced`):
`slab_traced` counts the launches of those wrappers that ran it.
"""

_ENABLED = True

LAUNCHES = {
    "slab_value": 0,
    "slab_value_and_grad": 0,
    "slab_value_and_grad_small": 0,
    "slab_vjp": 0,
    "slab_jvp": 0,
    "slab_traced": 0,
    "simplex_inverse_logdet": 0,
    "simplex_inverse_logdet_small": 0,
    "lkj_inverse": 0,
    "lkj_logdet": 0,
    "lkj_logdet_chol": 0,
    "simplex_inverse": 0,
    "simplex_forward_logdet": 0,
    "pd_inverse": 0,
    "pd_logdensity": 0,
    "pd_trace_grad": 0,
    "transcend_probe": 0,
    "prim_probe": 0,
    "launch_floor": 0,
}


def enable(flag: bool = True):
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch(fn: str, name: str, device, *args):
    """Call the C function `fn` of the kernel library on `device`'s current
    stream (the stream is appended to `args`); raise on a nonzero
    cudaError_t, else count one launch of `name`. Raises, launching
    nothing, while the kernels are disabled."""
    import torch

    from . import build

    if not _ENABLED:
        raise RuntimeError(
            f"kernels are disabled, and {name} has no plain path on the card; "
            "call kernels.enable(True) or move the tensors to the CPU"
        )
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.tbt_error_string(err).decode()}")
    LAUNCHES[name] += 1
