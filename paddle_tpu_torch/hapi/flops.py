"""FLOPs counter and parameter summary (the port's copies of
paddle_tpu/hapi/flops.py `flops` and paddle_tpu/__init__.py `summary`).

`flops` counts MACs-as-FLOPs for Linear, convolution, norm and pool
layers by running one forward, in eval mode and without gradients, with
shape-recording hooks on the leaf modules, on a float32 zeros input on
the network's device; `summary` counts parameters, each tied parameter
once."""
from __future__ import annotations

import torch

__all__ = ["flops", "summary"]


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _device(net):
    for p in net.parameters():
        return p.device
    return torch.device("cpu")


def flops(net, input_size, custom_ops=None, print_detail=False):
    """MACs-as-FLOPs of one forward over an input of `input_size`
    (reference: dynamic_flops.py): a Linear counts rows x in x out, a
    convolution batch x output positions x weight size, a norm 2 x input
    size, a pool its output size; `custom_ops` maps a class name to a
    counter (layer, inputs, output) -> int."""
    custom_ops = custom_ops or {}
    total = [0]
    rows = []
    hooks = []

    def count(layer, ins, out):
        cls = type(layer).__name__
        x = ins[0]
        n = 0
        if cls in custom_ops:
            n = custom_ops[cls](layer, ins, out)
        elif cls == "Linear":
            n = _prod(x.shape) // x.shape[-1] * layer.in_features \
                * layer.out_features
        elif cls.startswith("Conv"):
            w = layer.weight
            out_sp = _prod(out.shape[2:]) if len(out.shape) > 2 else 1
            n = out.shape[0] * out_sp * _prod(w.shape)
        elif "Norm" in cls:
            n = 2 * _prod(x.shape)
        elif "Pool" in cls:
            n = _prod(out.shape)
        if n:
            total[0] += n
            rows.append((cls, list(x.shape), list(out.shape), n))

    for name, sub in net.named_modules():
        if name and not any(True for _ in sub.children()):  # leaves only
            hooks.append(sub.register_forward_hook(count))
    try:
        x = torch.zeros(tuple(input_size), dtype=torch.float32,
                        device=_device(net))
        was_training = net.training
        net.eval()
        with torch.no_grad():
            net(x)
        if was_training:
            net.train()
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        for cls, si, so, n in rows:
            print(f"{cls:16s} {str(si):24s} -> {str(so):24s} {n:,}")
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]


def summary(net, input_size=None, dtypes=None, input=None):
    """Parameter-count summary (reference: hapi/model_summary.py)."""
    total = 0
    trainable = 0
    for _, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    print(f"Non-trainable params: {total - trainable}")
    return {"total_params": total, "trainable_params": trainable}
