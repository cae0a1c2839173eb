"""Recurrent layers (counterpart of paddle_tpu/nn/rnn.py): the cells
`SimpleRNNCell`, `LSTMCell` and `GRUCell`, `RNN` and `BiRNN` (an eager
loop of any cell), and `SimpleRNN`, `LSTM` and `GRU` over the fused op
`ops.rnn_ops.rnn`.

Weights are the reference's: W_ih [G*H, in], W_hh [G*H, H] (G = 1, 4, 3
gate blocks), b_ih and b_hh [G*H], drawn from Uniform(-1/sqrt(H),
1/sqrt(H)) unless a ParamAttr says otherwise, on the CPU from the
caller's `generator`. The fused classes name them `weight_ih_l{k}`,
`weight_hh_l{k}`, `bias_ih_l{k}`, `bias_hh_l{k}` (`_reverse` for the
second direction), registered in the reference's order, so that
`models.convert` carries them across.

`sequence_length` stays on the device in both the wrappers and the fused
op: the reference's RNN reads it on the host, the port builds the step
masks from it where it lies, with the same result, so a captured program
can hold either.
"""
from __future__ import annotations

import math

import torch

from ..framework.dtype import convert_dtype
from ..ops import rnn_ops
from . import functional as F
from . import initializer as I
from .layer_base import Layer
from .layers import LayerList

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "RNNBase", "SimpleRNN", "LSTM", "GRU"]


def _nested(shape):
    return (isinstance(shape, (list, tuple)) and len(shape) > 0
            and isinstance(shape[0], (list, tuple)))


class RNNCellBase(Layer):
    """The cells' base (reference: nn/rnn.py:31)."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """Tensors of [batch] + shape filled with `init_value` (a nested
        shape gives a nested structure of the same type), batch taken from
        batch_ref's axis `batch_dim_idx`, in `dtype` or batch_ref's, on
        batch_ref's device."""
        if shape is None:
            shape = self.state_shape
        batch = batch_ref.shape[batch_dim_idx]
        dt = convert_dtype(dtype) or batch_ref.dtype

        def build(s):
            if _nested(s):
                return type(s)(build(e) for e in s)
            return torch.full((batch,) + tuple(int(d) for d in s),
                              init_value, dtype=dt, device=batch_ref.device)
        return build(shape)


class _CellWeights(RNNCellBase):
    def __init__(self, input_size, hidden_size, gates, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr, generator):
        super().__init__()
        u = I.Uniform(-1.0 / math.sqrt(hidden_size),
                      1.0 / math.sqrt(hidden_size))
        G = gates * hidden_size
        self.weight_ih = self.create_parameter(
            (G, input_size), weight_ih_attr, default_initializer=u,
            generator=generator)
        self.weight_hh = self.create_parameter(
            (G, hidden_size), weight_hh_attr, default_initializer=u,
            generator=generator)
        self.bias_ih = self.create_parameter(
            (G,), bias_ih_attr, is_bias=True, default_initializer=u,
            generator=generator)
        self.bias_hh = self.create_parameter(
            (G,), bias_hh_attr, is_bias=True, default_initializer=u,
            generator=generator)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def _proj(self, x, w, b):
        """x @ w^T (+ b): op matmul_v2, as the reference's cells take it."""
        y = F.matmul(x, w, transpose_y=True)
        return y if b is None else y + b

    def extra_repr(self):
        return "%d, %d" % (self.input_size, self.hidden_size)


class SimpleRNNCell(_CellWeights):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh), act tanh or relu
    (reference: nn/rnn.py:54)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, generator=None):
        if activation not in ("tanh", "relu"):
            raise ValueError("activation for SimpleRNNCell should be tanh "
                             "or relu, but got %s" % (activation,))
        super().__init__(input_size, hidden_size, 1, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        pre = (self._proj(inputs, self.weight_ih, self.bias_ih)
               + self._proj(states, self.weight_hh, self.bias_hh))
        h = F.tanh(pre) if self.activation == "tanh" else F.relu(pre)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(_CellWeights):
    """Gates [i, f, g, o]; c' = f c + i g, h' = o tanh(c'); returns
    (h', (h', c')) (reference: nn/rnn.py:104)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, generator=None):
        super().__init__(input_size, hidden_size, 4, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        pre_h, pre_c = states
        gates = (self._proj(inputs, self.weight_ih, self.bias_ih)
                 + self._proj(pre_h, self.weight_hh, self.bias_hh))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = F.sigmoid(f) * pre_c + F.sigmoid(i) * F.tanh(g)
        h = F.sigmoid(o) * F.tanh(c)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(_CellWeights):
    """Gates [r, z, c], the reset gate applied after the hidden product;
    h' = (h - c) z + c (reference: nn/rnn.py:154)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, generator=None):
        super().__init__(input_size, hidden_size, 3, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        x_r, x_z, x_c = self._proj(inputs, self.weight_ih,
                                   self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_c = self._proj(states, self.weight_hh,
                                   self.bias_hh).chunk(3, dim=-1)
        r = F.sigmoid(x_r + h_r)
        z = F.sigmoid(x_z + h_z)
        c = F.tanh(x_c + r * h_c)
        h = (states - c) * z + c
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _mask_states(new, old, valid):
    """`new` where the row is valid, else `old` (reference: nn/rnn.py:247),
    through nested states."""
    if isinstance(new, (list, tuple)):
        return type(new)(_mask_states(n, o, valid) for n, o in zip(new, old))
    return torch.where(valid, new, old)


class RNN(Layer):
    """Any cell scanned over time, eagerly (reference: nn/rnn.py:206):
    returns (outputs stacked on the time axis, final states). With
    `sequence_length` [B], a step at or past a row's length outputs zeros
    and keeps the row's state; the masks come from the lengths on their
    device."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        states = initial_states
        t_axis = 0 if self.time_major else 1
        T = inputs.shape[t_axis]
        valid = None
        if sequence_length is not None:
            lens = torch.as_tensor(sequence_length, device=inputs.device)
            valid = (torch.arange(T, device=inputs.device)[:, None]
                     < lens[None, :])[..., None]
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if self.is_reverse else range(T)):
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, new_states = self.cell(x_t, states, **kwargs)
            if valid is not None:
                out = torch.where(valid[t], out, 0.0)
                new_states = _mask_states(new_states, states, valid[t])
            outs[t] = out
            states = new_states
        return torch.stack(outs, dim=t_axis), states


class BiRNN(Layer):
    """A forward and a reverse RNN over the same input, outputs concatenated
    on the last axis; states (forward, backward) (reference:
    nn/rnn.py:253)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        states_fw, states_bw = (None, None) if initial_states is None \
            else initial_states
        y_fw, s_fw = self.rnn_fw(inputs, states_fw, sequence_length,
                                 **kwargs)
        y_bw, s_bw = self.rnn_bw(inputs, states_bw, sequence_length,
                                 **kwargs)
        return torch.cat([y_fw, y_bw], dim=-1), (s_fw, s_bw)


class RNNBase(LayerList):
    """The fused multi-layer, one- or two-direction recurrence over
    `ops.rnn_ops.rnn` (reference: nn/rnn.py:277). forward(inputs,
    initial_states=None, sequence_length=None) -> (y, h_n), or for LSTM
    (y, (h_n, c_n)); initial states zeros by default, a tensor [L*D, B,
    H], or (h, c) for LSTM. Dropout between layers in training only."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, generator=None):
        super().__init__()
        if direction in ("bidirectional", "bidirect"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError("unknown direction %r" % (direction,))
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = float(dropout)
        G = rnn_ops.GATES[mode] * hidden_size
        u = I.Uniform(-1.0 / math.sqrt(hidden_size),
                      1.0 / math.sqrt(hidden_size))
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = (input_size if layer == 0
                         else hidden_size * self.num_directions)
                sfx = "%d%s" % (layer, "_reverse" if d == 1 else "")
                for kind, shape, attr, bias in (
                        ("weight_ih", (G, in_sz), weight_ih_attr, False),
                        ("weight_hh", (G, hidden_size), weight_hh_attr,
                         False),
                        ("bias_ih", (G,), bias_ih_attr, True),
                        ("bias_hh", (G,), bias_hh_attr, True)):
                    name = "%s_l%s" % (kind, sfx)
                    setattr(self, name, self.create_parameter(
                        shape, attr, is_bias=bias, default_initializer=u,
                        generator=generator))
                    self._weight_names.append(name)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        B = inputs.shape[1 if self.time_major else 0]
        LD = self.num_layers * self.num_directions
        lstm = self.mode == "LSTM"
        if initial_states is None:
            zeros = dict(size=(LD, B, self.hidden_size), dtype=inputs.dtype,
                         device=inputs.device)
            h0 = torch.zeros(**zeros)
            c0 = torch.zeros(**zeros) if lstm else None
        elif lstm:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, None
        # the reference draws a key only for a dropout that applies
        key = (True if self.dropout > 0.0 and self.training
               and self.num_layers > 1 else None)
        outs = rnn_ops.rnn(
            inputs, h0, c0, sequence_length, key,
            *[getattr(self, n) for n in self._weight_names], mode=self.mode,
            num_layers=self.num_layers, num_directions=self.num_directions,
            time_major=self.time_major,
            dropout=self.dropout if self.training else 0.0, has_bias=True)
        if lstm:
            y, h_n, c_n = outs
            return y, (h_n, c_n)
        return outs

    def extra_repr(self):
        return "%s, %d, %d, num_layers=%d, directions=%d" % (
            self.mode, self.input_size, self.hidden_size, self.num_layers,
            self.num_directions)


class SimpleRNN(RNNBase):
    """reference: nn/rnn.py:351 (activation "tanh" or "relu")."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 generator=None):
        if activation not in ("tanh", "relu"):
            raise ValueError("activation for SimpleRNN should be tanh or "
                             "relu, but got %s" % (activation,))
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU",
                         input_size, hidden_size, num_layers, direction,
                         time_major, dropout, weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, generator)


class LSTM(RNNBase):
    """reference: nn/rnn.py:365."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, generator=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)


class GRU(RNNBase):
    """reference: nn/rnn.py:375."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, generator=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         generator)
