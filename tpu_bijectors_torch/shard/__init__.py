"""Sampler-state checkpoints of the port (counterpart of
`tpu_bijectors.shard`; its chain- and parameter-parallel meshes are not
ported)."""

from .checkpoint import load_sampler_state, save_sampler_state

__all__ = ["load_sampler_state", "save_sampler_state"]
