"""Layers and functional ops of the ported paths."""
from . import functional, initializer
from .layer_base import Layer, ParamAttr
from .layers import *  # noqa: F401,F403
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
