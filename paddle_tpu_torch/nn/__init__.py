"""Layers and functional ops of the ported paths."""
from . import functional
from .layers import Dropout, Embedding, LayerNorm, Linear, Tanh
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear",
           "Tanh", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
