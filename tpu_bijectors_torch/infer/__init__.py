"""Inference layer of the port (counterpart of `tpu_bijectors.infer`):
NUTS and HMC, ChEES, ADVI, SMC, MAP + Laplace, Pathfinder, the evidence
estimators, PSIS-LOO / WAIC, parallel tempering, the ensemble sampler,
SBC, the predictive checks and NeuTra."""

from .adapt import (
    StepSizeAdaptState,
    WelfordState,
    build_schedule,
    stepsize_init,
    stepsize_update,
    welford_cov_init,
    welford_cov_update_batch,
    welford_covariance,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from .advi import ADVIResult, FlowPosterior, FullRankGaussian, MeanFieldGaussian, fit_advi
from .chees import CheesState, CheesStats, run_chees
from .ensemble import EnsembleResult, run_ensemble
from .evidence import BridgeResult, ISResult, bridge_sampling_evidence, importance_sampling_evidence
from .hmc import IntegratorState, NutsInfo, hmc_kernel, leapfrog, nuts_kernel
from .hmc_batched import hmc_kernel_batched, nuts_kernel_batched
from .loo import LOOResult, WAICResult, fit_gpd, psis_loo, waic
from .map_laplace import LaplaceApprox, MAPResult, fit_map, laplace_approximation, map_laplace
from .model import Model, as_batched
from .neutra import NeutraResult, fit_neutra_flow, neutra_logdensity, neutra_sample
from .pathfinder import PathfinderResult, fit_pathfinder, multipath_pathfinder
from .predictive import posterior_predictive, ppc_pvalue, prior_predictive
from .sampler import (
    RunStats,
    SamplerState,
    init_sampler,
    resume_sampling,
    sample_with_kernel,
    warmup_and_sample,
)
from .sbc import SBCResult, sbc_ranks, sbc_uniformity
from .smc import SMCResult, run_smc, systematic_resample
from .tempering import PTResult, default_ladder, run_parallel_tempering

__all__ = [
    "Model",
    "as_batched",
    "nuts_kernel",
    "nuts_kernel_batched",
    "hmc_kernel",
    "hmc_kernel_batched",
    "leapfrog",
    "IntegratorState",
    "NutsInfo",
    "SamplerState",
    "RunStats",
    "init_sampler",
    "warmup_and_sample",
    "resume_sampling",
    "sample_with_kernel",
    "fit_advi",
    "MeanFieldGaussian",
    "FullRankGaussian",
    "FlowPosterior",
    "ADVIResult",
    "run_smc",
    "SMCResult",
    "systematic_resample",
    "run_chees",
    "CheesState",
    "CheesStats",
    "fit_map",
    "laplace_approximation",
    "map_laplace",
    "MAPResult",
    "LaplaceApprox",
    "fit_pathfinder",
    "multipath_pathfinder",
    "PathfinderResult",
    "bridge_sampling_evidence",
    "importance_sampling_evidence",
    "BridgeResult",
    "ISResult",
    "psis_loo",
    "waic",
    "fit_gpd",
    "LOOResult",
    "WAICResult",
    "run_parallel_tempering",
    "PTResult",
    "default_ladder",
    "run_ensemble",
    "EnsembleResult",
    "neutra_logdensity",
    "fit_neutra_flow",
    "neutra_sample",
    "NeutraResult",
    "sbc_ranks",
    "sbc_uniformity",
    "SBCResult",
    "prior_predictive",
    "posterior_predictive",
    "ppc_pvalue",
    # adaptation
    "stepsize_init",
    "stepsize_update",
    "StepSizeAdaptState",
    "welford_init",
    "welford_cov_init",
    "welford_cov_update_batch",
    "welford_covariance",
    "welford_update_batch",
    "welford_variance",
    "WelfordState",
    "build_schedule",
]
