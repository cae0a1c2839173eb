"""Kernels of the port: CUDA sources in csrc/, built by _build, wrapped
with their gates and plain versions in cuda_kernels."""
from . import cuda_kernels

__all__ = ["cuda_kernels"]
