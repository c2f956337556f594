"""Chain- and parameter-parallel inference over `torch.distributed`, and
sampler-state checkpoints (counterpart of `tpu_bijectors.shard`): the
JAX package's device meshes become `DeviceMesh`es of process-group ranks,
each rank running its own block (`chain_parallel.py`,
`param_parallel.py`)."""

from .chain_parallel import (
    build_advi_sharded,
    build_nuts_sharded,
    build_resume_sharded,
    build_smc_sharded,
    chain_parallel_advi,
    chain_parallel_chees,
    chain_parallel_nuts,
    chain_parallel_pathfinder,
    chain_parallel_pt,
    chain_parallel_resume,
    chain_parallel_smc,
    distributed_systematic_resample,
    gather_chains,
    make_mesh,
    multihost_init,
    shard_chains,
)
from .checkpoint import load_sampler_state, save_sampler_state
from .param_parallel import (
    ParamLayout,
    build_param_layout,
    param_parallel_from_linked,
    param_parallel_logdensity,
    shard_params,
)

__all__ = [
    "make_mesh",
    "multihost_init",
    "shard_chains",
    "gather_chains",
    "build_advi_sharded",
    "build_nuts_sharded",
    "build_resume_sharded",
    "build_smc_sharded",
    "chain_parallel_advi",
    "chain_parallel_chees",
    "chain_parallel_nuts",
    "chain_parallel_pathfinder",
    "chain_parallel_pt",
    "chain_parallel_resume",
    "chain_parallel_smc",
    "distributed_systematic_resample",
    "shard_params",
    "ParamLayout",
    "build_param_layout",
    "param_parallel_from_linked",
    "param_parallel_logdensity",
    "save_sampler_state",
    "load_sampler_state",
]
