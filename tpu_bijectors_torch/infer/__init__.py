"""Inference layer of the port (counterpart of `tpu_bijectors.infer`)."""

from .model import Model

__all__ = ["Model"]
