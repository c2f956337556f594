"""Hand-written CUDA kernels of the port (counterpart of
`tpu_bijectors.kernels`).

Each kernel has a plain PyTorch version of the same function beside its
wrapper. A wrapper runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card; it never gives way to the plain version on
the card. `LAUNCHES` counts, per wrapper, the kernel launches it made.
`enable(False)` sends CPU tensors down the composed per-leaf path instead
of the fused one; on the card, where the composed path's own kernels are
not ported yet, a call with the kernels off raises.
"""

_ENABLED = True

LAUNCHES = {"slab_value": 0, "slab_value_and_grad": 0, "slab_vjp": 0}


def enable(flag: bool = True):
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
