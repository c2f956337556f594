"""Sampler-state checkpoint and resume, PyTorch counterpart of
`tpu_bijectors/shard/checkpoint.py`.

A whole sampler state (SamplerState, CheesState: positions, the
generator, step size, mass matrix, adaptation accumulators, iteration)
round-trips through one .npz file: its leaves in order (`arr_0`, ...),
the generator as its `get_state()` bytes, and a description of the
structure (`__treedef__`). A loaded state continues the run bit for bit on
the same device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _leaves(state):
    """The leaves of nested NamedTuples and tuples, in order."""
    if isinstance(state, tuple):
        return [leaf for child in state for leaf in _leaves(child)]
    return [state]


def _structure(state):
    if isinstance(state, tuple):
        fields = getattr(state, "_fields", None) or [str(i) for i in range(len(state))]
        return {type(state).__name__: {f: _structure(c) for f, c in zip(fields, state)}}
    return type(state).__name__


def _to_host(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore(array, like):
    if isinstance(like, torch.Generator):
        g = torch.Generator(device=like.device)
        g.set_state(torch.from_numpy(array))
        return g
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(array).to(device=like.device, dtype=like.dtype)
    return type(like)(array.item())


def _unflatten(like, leaves):
    if isinstance(like, tuple):
        children = [_unflatten(c, leaves) for c in like]
        return type(like)(*children) if hasattr(like, "_fields") else type(like)(children)
    return next(leaves)


def save_sampler_state(path: str, state) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        *(_to_host(leaf) for leaf in _leaves(state)),
        __treedef__=np.frombuffer(json.dumps(_structure(state)).encode(), dtype=np.uint8),
    )


def load_sampler_state(path: str, like):
    """`like`: a state of the same structure (e.g. from init_sampler); the
    leaves take its devices and dtypes, and the generator a new
    `torch.Generator` on its generator's device."""
    with np.load(path) as data:
        leaves = [data[f"arr_{i}"] for i in range(len(data.files) - 1)]
    flat_like = _leaves(like)
    if len(leaves) != len(flat_like):
        raise ValueError(f"checkpoint has {len(leaves)} leaves; expected {len(flat_like)}")
    return _unflatten(like, iter([_restore(a, r) for a, r in zip(leaves, flat_like)]))
