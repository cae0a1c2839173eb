"""The fused recurrent op `rnn` (counterpart of paddle_tpu/ops/rnn_ops.py):
SimpleRNN (tanh or relu), LSTM and GRU, many layers, one or two
directions, `time_major`, lengths, inter-layer dropout.

The design is the reference's:
  * the input projection x @ W_ih^T + b_ih of a direction is hoisted out
    of the time loop as one GEMM over all T * B rows; the loop holds only
    h @ W_hh^T (one addmm a step, onto the step's slice of that
    projection) and the cell's pointwise math;
  * gates as the reference's cells chunk them: LSTM [i, f, g, o],
    c' = f c + i g, h' = o tanh(c'); GRU [r, z, c] with the reset gate
    applied after the hidden product (r * (h W_hc^T + b_hc)) and
    h' = (h - c) z + c;
  * lengths: a step at or past a row's `seq_len` keeps that row's state
    and outputs zeros, in both directions (the reverse direction scans
    from T - 1 down, so it starts at each row's last valid step). The
    mask is built on the device from `seq_len` with no host read, so a
    captured program can hold the op;
  * dropout between layers (p > 0 and a `dropout_key` given, as the
    reference's op drops only with a key) takes its keep mask from
    `nn.functional._keep`: on the card the Philox bits kernel and the
    step's Philox word (a captured step draws new masks on replay), on
    the CPU the CPU generator.

The loop is composed PyTorch ops, as the reference's is a scan over
composed XLA ops: no TPU kernel stands behind it. Matrix products are
torch.matmul / addmm, not the matmul_v2 op, so auto_cast casts nothing
inside the op, as in the reference (its `rnn` is on neither list).
"""
from __future__ import annotations

import torch

from ..framework.dispatch import primitive

__all__ = ["rnn", "MODES", "GATES"]

MODES = ("RNN_TANH", "RNN_RELU", "LSTM", "GRU")
# gate blocks of W_ih / W_hh by mode
GATES = {"RNN_TANH": 1, "RNN_RELU": 1, "LSTM": 4, "GRU": 3}


def _cell(mode, gx, h, c, w_hh, b_hh):
    """One step from the step's input projection `gx` [B, G*H] (b_ih and,
    but for GRU, b_hh already added): (h', c')."""
    if mode == "GRU":
        hg = torch.matmul(h, w_hh.t()) if b_hh is None else torch.addmm(
            b_hh, h, w_hh.t())
        x_r, x_z, x_c = gx.chunk(3, dim=-1)
        h_r, h_z, h_c = hg.chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        cand = torch.tanh(x_c + r * h_c)
        return (h - cand) * z + cand, c
    g = torch.addmm(gx, h, w_hh.t())
    if mode == "LSTM":
        i, f, gg, o = g.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    if mode == "RNN_TANH":
        return torch.tanh(g), c
    return torch.maximum(g, g.new_zeros(())), c


def _direction(mode, x, h, c, w_ih, w_hh, b_ih, b_hh, valid, reverse):
    """One direction over time-major x [T, B, I]: (outputs [T, B, H], h_T,
    c_T). `valid` [T, B, 1] bool or None."""
    T, B = x.shape[0], x.shape[1]
    gx = torch.matmul(x.reshape(T * B, -1), w_ih.t())
    if b_ih is not None:
        gx = gx + b_ih
    if b_hh is not None and mode != "GRU":
        gx = gx + b_hh
    gx = gx.reshape(T, B, -1)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, c_new = _cell(mode, gx[t], h, c, w_hh, b_hh)
        if valid is None:
            outs[t] = h_new
        else:
            outs[t] = torch.where(valid[t], h_new, 0.0)
            h_new = torch.where(valid[t], h_new, h)
            if c is not None:
                c_new = torch.where(valid[t], c_new, c)
        h, c = h_new, c_new
    return torch.stack(outs), h, c


@primitive("rnn")
def rnn(x, h0, c0, seq_len, dropout_key, *weights, mode="LSTM",
        num_layers=1, num_directions=1, time_major=False, dropout=0.0,
        has_bias=True):
    """(y, h_n) for RNN_TANH / RNN_RELU / GRU, (y, h_n, c_n) for LSTM
    (reference: ops/rnn_ops.py:87).

    x [B, T, I] ([T, B, I] with time_major); h0, c0 [L*D, B, H] (c0 None:
    zeros); seq_len [B] integer or None; `dropout_key` stands for the
    reference's PRNG key: None drops nothing, whatever `dropout` is, as
    in the reference; any other value (RNNBase passes True) turns the
    inter-layer dropout on, its mask drawn by `_keep`, not from the value;
    weights per (layer, direction) w_ih [G*H, in], w_hh [G*H, H] and, with
    has_bias, b_ih, b_hh [G*H]. y [B, T, D*H] (time-major with
    time_major); h_n, c_n [L*D, B, H]."""
    if mode not in GATES:
        raise ValueError("rnn mode %r (one of %s)" % (mode, MODES))
    if not time_major:
        x = x.transpose(0, 1)
    valid = None
    if seq_len is not None:
        steps = torch.arange(x.shape[0], device=x.device)
        valid = (steps[:, None] < seq_len.to(x.device)[None, :])[..., None]
    per = 4 if has_bias else 2
    lstm = mode == "LSTM"
    layer_in, idx = x, 0
    h_fin, c_fin = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(num_directions):
            w_ih, w_hh = weights[idx], weights[idx + 1]
            b_ih, b_hh = ((weights[idx + 2], weights[idx + 3]) if has_bias
                          else (None, None))
            idx += per
            s = layer * num_directions + d
            c = (c0[s] if c0 is not None else torch.zeros_like(h0[s])) \
                if lstm else None
            y, h_f, c_f = _direction(mode, layer_in, h0[s], c, w_ih, w_hh,
                                     b_ih, b_hh, valid, reverse=d == 1)
            outs.append(y)
            h_fin.append(h_f)
            c_fin.append(c_f)
        layer_in = outs[0] if num_directions == 1 else torch.cat(outs, -1)
        if (dropout > 0.0 and dropout_key is not None
                and layer < num_layers - 1
                and layer_in.device.type != "meta"):
            from ..nn.functional import _keep
            keep = _keep(layer_in.shape, dropout, layer_in.device)
            layer_in = torch.where(keep, layer_in / (1.0 - dropout), 0.0)
    y = layer_in if time_major else layer_in.transpose(0, 1)
    if lstm:
        return y, torch.stack(h_fin), torch.stack(c_fin)
    return y, torch.stack(h_fin)
