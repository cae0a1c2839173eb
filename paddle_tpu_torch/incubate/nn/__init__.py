"""Fused layers' functionals (counterpart of paddle_tpu/incubate/nn)."""
from . import functional

__all__ = ["functional"]
