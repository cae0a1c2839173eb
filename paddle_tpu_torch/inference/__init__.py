"""Inference of the port: GPT serving (inference/serving)."""
from . import serving

__all__ = ["serving"]
