"""Inference layer of the port (counterpart of `tpu_bijectors.infer`):
NUTS and HMC, ChEES, ADVI and SMC."""

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
from .hmc import IntegratorState, NutsInfo, hmc_kernel, leapfrog, nuts_kernel
from .hmc_batched import hmc_kernel_batched, nuts_kernel_batched
from .model import Model, as_batched
from .sampler import (
    RunStats,
    SamplerState,
    init_sampler,
    resume_sampling,
    sample_with_kernel,
    warmup_and_sample,
)
from .smc import SMCResult, run_smc, systematic_resample

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
