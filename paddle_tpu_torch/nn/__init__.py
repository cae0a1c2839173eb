"""Layers and functional ops of the ported paths."""
from . import functional, initializer
from .layer_base import Layer, ParamAttr
from .layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                     BatchNorm2D, BatchNorm3D, Conv1D, Conv2D, Conv3D,
                     CrossEntropyLoss, Dropout, Embedding, Flatten,
                     LayerNorm, Linear, MaxPool2D, ReLU, Sequential, Tanh)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "Layer", "ParamAttr",
           "AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv2D", "Conv3D",
           "CrossEntropyLoss", "Dropout", "Embedding", "Flatten",
           "LayerNorm", "Linear", "MaxPool2D", "ReLU", "Sequential", "Tanh",
           "MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
