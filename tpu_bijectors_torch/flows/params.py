"""The trainable tensors of a flow, and the flow rebuilt from them.

The JAX package's flows are pytrees: `jax.grad` and optax reach every
array leaf. The port's flows are frozen dataclasses, so the optimisers
(`torch.optim`, ADVI's loop) are handed the list `flow_parameters(flow)`
and the flow is rebuilt around it with `with_flow_parameters`, as ADVI
rebuilds its Gaussian families with `type(q)(*params)`.

The walk sees through `Chain` and `Invert` (any dataclass field holding a
transform) and into tuples and lists (a `Coupling`'s tuple of conditioner
parameters). A class names the tensor fields that are constants in
`constant_fields` (the MADE masks); every other floating tensor field is
trainable.
"""

from __future__ import annotations

import dataclasses

import torch


def _constant(obj, name: str) -> bool:
    return name in getattr(type(obj), "constant_fields", ())


def flow_parameters(flow) -> list:
    """The trainable floating tensors of `flow`, in a fixed order (the
    order of the JAX package's pytree leaves)."""
    out = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            if obj.is_floating_point():
                out.append(obj)
        elif isinstance(obj, (tuple, list)):
            for v in obj:
                walk(v)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                if f.init and not _constant(obj, f.name):
                    walk(getattr(obj, f.name))

    walk(flow)
    return out


def with_flow_parameters(flow, tensors):
    """`flow` rebuilt with `tensors` (in `flow_parameters`' order) in place
    of its trainable tensors; their autograd history is kept."""
    it = iter(tensors)

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            return next(it) if obj.is_floating_point() else obj
        if isinstance(obj, (tuple, list)):
            return type(obj)(walk(v) for v in obj)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            changes = {f.name: walk(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                       if f.init and not _constant(obj, f.name)}
            return dataclasses.replace(obj, **changes)
        return obj

    out = walk(flow)
    if next(it, None) is not None:
        raise ValueError("more tensors than the flow has parameters")
    return out
