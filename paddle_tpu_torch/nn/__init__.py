"""Layers and functional ops of the serving path."""
from . import functional
from .layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear"]
