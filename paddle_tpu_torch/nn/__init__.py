"""Layers and functional ops of the ported paths."""
from . import functional, initializer
from .layer_base import Layer, ParamAttr
from .layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                     BatchNorm2D, BatchNorm3D, BCELoss, BCEWithLogitsLoss,
                     CELU, Conv1D, Conv2D, Conv3D, CrossEntropyLoss, Dropout,
                     ELU, Embedding, Flatten, GELU, GLU, Hardshrink,
                     Hardsigmoid, Hardswish, Hardtanh, HingeEmbeddingLoss,
                     KLDivLoss, L1Loss, LayerDict, LayerList, LayerNorm,
                     LeakyReLU, Linear, LogSigmoid, LogSoftmax,
                     MarginRankingLoss, MaxPool2D, Maxout, Mish, MSELoss,
                     NLLLoss, ParameterList, PReLU, ReLU, ReLU6, SELU,
                     Sequential, Sigmoid, Silu, SmoothL1Loss, Softmax,
                     Softplus, Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                     ThresholdedReLU)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from . import layers as _layers, rnn as _rnn

__all__ = (["functional", "initializer", "Layer", "ParamAttr"]
           + list(_layers.__all__)
           + [n for n in _rnn.__all__ if n != "RNNBase"]
           + ["MultiHeadAttention", "Transformer", "TransformerDecoder",
              "TransformerDecoderLayer", "TransformerEncoder",
              "TransformerEncoderLayer"])
