"""Carry weights between the JAX package's model and the port's module.

The port keeps the reference's parameter and buffer names and layouts (a
Linear weight is [in, out] in both, a batch norm's running statistics are
`<layer>._mean` and `<layer>._variance`), so a state dict of numpy arrays
taken from `paddle_tpu_model.state_dict()` maps one to one, and back:

    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_reference_state(port_model, state)
    ...
    arrays = export_reference_state(port_model)   # name -> numpy

Both sides list a parameter that is used twice (BERT's word embeddings,
which are also its MLM decoder weight) once, under the name of its first
use, so a tied weight maps one to one. GPT, BERT, the ResNets, LeNet
(`features.<i>.weight`, `fc.<i>.weight`: OIHW convolutions, [in, out]
Linears), `nn.Transformer` (`encoder.layers.<i>.self_attn.q_proj.weight`,
`decoder.layers.<i>.cross_attn...`, `norm1`-`norm3`, and a model's own
names around it), the recurrent classes (`weight_ih_l<k>`,
`weight_hh_l<k>`, `bias_ih_l<k>`, `bias_hh_l<k>`, `_reverse` for the
second direction; a cell's `weight_ih` ... `bias_hh`), the containers
(`<i>.` or `<key>.` before each sublayer's names, a ParameterList's
`<i>`), the LSTM language model of chip_smoke.py phase 24, the second
part of nn (a transposed convolution's weight [in, out / groups, *k] and
bias, GroupNorm's and the batch norms' weight and bias, an InstanceNorm's
`scale` and `bias`, SpectralNorm's `weight_u` and `weight_v`, Bilinear's
weight [out, in1, in2] and bias, HSigmoidLoss's weight [rows, feature]
and bias [rows, 1], PReLU's weight) and chip_smoke.py phase 26's UNet
carry over this way.

`pack_qkv` packs a MultiHeadAttention's q/k/v projections into
`fused_multi_head_attention`'s fused [3, H, head_dim, E] layout.

`set_state_dict` is the reference's `Layer.set_state_dict`: names the
module lacks are skipped and reported, not raised on; `Model.load` and
the checkpoint engine load through it.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["load_reference_state", "export_reference_state",
           "set_state_dict", "pack_qkv"]


def _tensors(module):
    """The module's parameters and buffers by name (each once)."""
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return out


def load_reference_state(module: torch.nn.Module,
                         state: Mapping[str, np.ndarray]) -> None:
    """Copy every array of `state` into the parameter or buffer of the same
    name, in place, on its device (a built step holds their addresses).
    Raises when a name is missing on either side or a shape differs: a
    silent skip would leave a weight at its random init or a running
    statistic at its start."""
    params = _tensors(module)
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError("state dict does not match the module: missing %s, "
                       "unexpected %s" % (missing, extra))
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(state[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError("%s: shape %s in the state dict, %s in the "
                                 "module" % (name, arr.shape, tuple(p.shape)))
            p.copy_(torch.tensor(arr, dtype=p.dtype))


@torch.no_grad()
def set_state_dict(module: torch.nn.Module, state_dict) -> tuple:
    """The reference's Layer.set_state_dict, in place: each value (a
    tensor or an array) is copied into the parameter or buffer of its
    name, on its device (a built step holds their addresses); names the
    module lacks are skipped, a shape that differs raises ValueError.
    Returns (missing, unexpected) names."""
    own = module.state_dict(keep_vars=True)
    missing = [k for k in own if k not in state_dict]
    unexpected = []
    for k, v in state_dict.items():
        if k not in own:
            unexpected.append(k)
            continue
        dst = own[k]
        src = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.require(v, requirements="C"))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError("shape mismatch for %s: got %s, expected %s"
                             % (k, list(src.shape), list(dst.shape)))
        dst.copy_(src)
    return missing, unexpected


def export_reference_state(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The way back: every parameter and buffer as a numpy array on the
    host, keyed by the reference's names. numpy has no bfloat16, so a
    bfloat16 tensor comes back as float32 (exactly: bfloat16 widens
    without rounding)."""
    out = {}
    for name, p in _tensors(module).items():
        t = p.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.cpu().numpy().copy()
    return out


def pack_qkv(weights, biases, num_heads):
    """`fused_multi_head_attention`'s (qkv_weight [3, H, head_dim, E],
    qkv_bias [3, H, head_dim]) from the q, k and v projections' [E, E]
    weights ([in, out], as Linear holds them) and [E] biases: row
    (j, h, d) of the packed weight is output column h * head_dim + d of
    projection j. Takes and returns numpy arrays or torch tensors alike,
    so that both packages' weights pack from the same arrays."""
    def stack(ts):
        return (torch.stack(list(ts)) if isinstance(ts[0], torch.Tensor)
                else np.stack(ts))
    E = weights[0].shape[0]
    shape = (num_heads, E // num_heads)
    w = stack([wj.T.reshape(shape + (E,)) for wj in weights])
    b = stack([bj.reshape(shape) for bj in biases])
    return w, b
