"""Inference layer of the port (counterpart of `tpu_bijectors.infer`)."""

from .hmc_batched import nuts_kernel_batched
from .model import Model
from .sampler import resume_sampling, sample_with_kernel, warmup_and_sample

__all__ = [
    "Model",
    "nuts_kernel_batched",
    "resume_sampling",
    "sample_with_kernel",
    "warmup_and_sample",
]
